"""Ghost exchange between shard blocks, and the gathers of a sharded run.

No reference counterpart: the reference's exchange is ``jax.lax.ppermute``
inside ``shard_map`` (``climate_model_tpu/dist/packed_halo.py:61-104``). One
interface, two implementations:

* ``LocalExchange``: every shard in this process; copies between blocks.
* ``DistExchange``: one shard per rank of ``torch.distributed``; the edge
  slabs of all fields go out packed in one buffer per direction with
  ``batch_isend_irecv``.

Semantics, as the reference's:

* ``refresh_cols`` (``refresh_cols``, ``:61-75``): the periodic lon ring.
  A block's west ghost columns get its west neighbour's last interior
  columns, its east ghost columns the east neighbour's first; over the full
  block height. A no-op for one shard in lon. On a 2-wide ring the east and
  west neighbour are the same rank: the two messages carry their own tags,
  and every rank posts them in the same order.
* ``start_lat`` (``lat_edges``/``apply_lat``, ``:78-104``): the open lat
  chain. A block's south ghost rows get its south neighbour's top interior
  rows, its north ghost rows the north neighbour's bottom interior rows,
  over the full block width (ghost columns included, so a refresh of the
  columns first makes the corners right). A polar side has no ghost rows
  and receives nothing. ``start_lat`` returns a handle at once; its
  ``wait()`` writes the rows, so that the halo-overlap schedule can launch
  the main kernels between the two.

Fields are lists (one per local shard) of lists of block tensors, written
in place.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from .mesh import Mesh
from .sharding import Layout

# message tags: the direction the data travels
_EAST, _WEST, _NORTH, _SOUTH = 0, 1, 2, 3


class Exchange:
    """What a sharded run needs from the shards' placement."""

    def __init__(self, mesh: Mesh, layouts: list):
        self.mesh = mesh
        self.layouts = layouts              # of every shard, shard order

    def neighbours(self, lay: Layout) -> dict:
        """Shard of each neighbour: lon ring always, lat chain where it
        exists (None at a polar side)."""
        m, a, b = self.mesh, lay.lat_idx, lay.lon_idx
        return {"west": m.shard(a, b - 1), "east": m.shard(a, b + 1),
                "south": m.shard(a - 1, b) if lay.gs else None,
                "north": m.shard(a + 1, b) if lay.gn else None}

    # slabs, in block coordinates (full height for columns, full width for
    # rows)
    @staticmethod
    def _col_src(lay: Layout, side: str) -> slice:
        """Interior columns that go to the neighbour on ``side``."""
        if side == "east":
            return slice(lay.nx_l, lay.nx_l + lay.gx)
        return slice(lay.gx, 2 * lay.gx)

    @staticmethod
    def _col_dst(lay: Layout, side: str) -> slice:
        """Ghost columns filled from the neighbour on ``side``."""
        if side == "west":
            return slice(0, lay.gx)
        return slice(lay.gx + lay.nx_l, lay.nx_b)

    @staticmethod
    def _row_src(lay: Layout, side: str, width: int) -> slice:
        """Interior rows that go to the neighbour on ``side``: ``width`` of
        its ghost rows."""
        if side == "north":
            return slice(lay.gs + lay.ny_l - width, lay.gs + lay.ny_l)
        return slice(lay.gs, lay.gs + width)

    @staticmethod
    def _row_dst(lay: Layout, side: str) -> slice:
        if side == "south":
            return slice(0, lay.gs)
        return slice(lay.gs + lay.ny_l, lay.ny_b)

    def refresh_cols(self, fields: list):
        raise NotImplementedError

    def start_lat(self, fields: list):
        raise NotImplementedError

    def refresh(self, fields: list):
        """Blocking refresh of all ghosts: columns, then rows."""
        self.refresh_cols(fields)
        self.start_lat(fields).wait()

    def all_interiors(self, parts: list) -> list:
        """One tensor per shard of the mesh (shard order), from the local
        shards' ``parts``."""
        raise NotImplementedError


class _Done:
    def __init__(self, fn=None):
        self._fn = fn

    def wait(self):
        if self._fn is not None:
            self._fn()


class LocalExchange(Exchange):
    """Every shard of the mesh in this process (local index == shard):
    copies between blocks."""

    def refresh_cols(self, fields: list):
        if self.mesh.n_lon == 1:
            return
        for s, lay in enumerate(self.layouts):
            nb = self.neighbours(lay)
            for side, other in (("west", "east"), ("east", "west")):
                src_lay = self.layouts[nb[side]]
                dst, src = self._col_dst(lay, side), self._col_src(src_lay,
                                                                   other)
                for x, y in zip(fields[s], fields[nb[side]]):
                    x[..., dst].copy_(y[..., src])

    def start_lat(self, fields: list):
        if self.mesh.n_lat == 1:
            return _Done()

        def apply():
            for s, lay in enumerate(self.layouts):
                nb = self.neighbours(lay)
                for side, other in (("south", "north"), ("north", "south")):
                    if nb[side] is None:
                        continue
                    dst = self._row_dst(lay, side)
                    src = self._row_src(self.layouts[nb[side]], other,
                                        dst.stop - dst.start)
                    for x, y in zip(fields[s], fields[nb[side]]):
                        x[..., dst, :].copy_(y[..., src, :])

        return _Done(apply)

    def all_interiors(self, parts: list) -> list:
        return list(parts)


def _pack(slabs: list) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in slabs])


def _unpack(buf: torch.Tensor, dsts: list):
    o = 0
    for d in dsts:
        n = d.numel()
        d.copy_(buf[o:o + n].view(d.shape))
        o += n


class DistExchange(Exchange):
    """One shard per rank of ``torch.distributed`` (NCCL on the card, gloo
    on the CPU)."""

    @staticmethod
    def _exchange(sends: list, recvs: list):
        """Post one exchange. ``sends``: (peer, tag, source slabs);
        ``recvs``: (peer, tag, ghost slabs). Each goes packed in one
        buffer. The order matters where the transport ignores tags (NCCL
        matches a pair's messages in the order they were posted): every
        rank sends east then west, and receives from the west then from
        the east. Returns a handle whose ``wait()`` writes the ghosts."""
        ops = [tdist.P2POp(tdist.isend, _pack(srcs), peer, tag=tag)
               for peer, tag, srcs in sends]
        into = []
        for peer, tag, ghosts in recvs:
            buf = torch.empty(sum(g.numel() for g in ghosts),
                              dtype=ghosts[0].dtype, device=ghosts[0].device)
            ops.append(tdist.P2POp(tdist.irecv, buf, peer, tag=tag))
            into.append((buf, ghosts))
        reqs = tdist.batch_isend_irecv(ops) if ops else []

        def apply():
            for r in reqs:
                r.wait()
            for buf, ghosts in into:
                _unpack(buf, ghosts)

        return _Done(apply)

    def refresh_cols(self, fields: list):
        if self.mesh.n_lon == 1:
            return
        (xs,), lay = fields, self.layouts[self.mesh.rank]
        nb = self.neighbours(lay)
        # east-bound data (tag _EAST) fills the east neighbour's west
        # ghosts, west-bound data (_WEST) the west neighbour's east ghosts
        sends = [(nb[side], tag, [x[..., self._col_src(lay, side)]
                                  for x in xs])
                 for side, tag in (("east", _EAST), ("west", _WEST))]
        recvs = [(nb[side], tag, [x[..., self._col_dst(lay, side)]
                                  for x in xs])
                 for side, tag in (("west", _EAST), ("east", _WEST))]
        self._exchange(sends, recvs).wait()

    def start_lat(self, fields: list):
        if self.mesh.n_lat == 1:
            return _Done()
        (xs,), lay = fields, self.layouts[self.mesh.rank]
        nb = self.neighbours(lay)
        sends, recvs = [], []
        for side, tag_out, tag_in in (("north", _NORTH, _SOUTH),
                                      ("south", _SOUTH, _NORTH)):
            if nb[side] is None:
                continue
            dst = self._row_dst(lay, side)
            src = self._row_src(lay, side, dst.stop - dst.start)
            sends.append((nb[side], tag_out, [x[..., src, :] for x in xs]))
            recvs.append((nb[side], tag_in, [x[..., dst, :] for x in xs]))
        return self._exchange(sends, recvs)

    def all_interiors(self, parts: list) -> list:
        (x,) = parts
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.mesh.size)]
        tdist.all_gather(out, x)
        return out


def make_exchange(mesh: Mesh, layouts: list) -> Exchange:
    return DistExchange(mesh, layouts) if mesh.distributed \
        else LocalExchange(mesh, layouts)
