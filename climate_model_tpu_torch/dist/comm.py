"""Ghost exchange between shard blocks, and the gathers of a sharded run.

No reference counterpart: the reference's exchange is ``jax.lax.ppermute``
inside ``shard_map`` (``climate_model_tpu/dist/packed_halo.py:61-104``). One
interface, two implementations:

* ``LocalExchange``: every shard in this process; copies between blocks.
* ``DistExchange``: one shard per rank of ``torch.distributed``; the edge
  slabs of all fields go out packed in one buffer per direction with
  ``batch_isend_irecv``. A captured step (``graphs.py``) first calls
  ``use_static_buffers``: each exchange of the step then packs into, and
  unpacks from, send and receive buffers allocated once for it; the eager
  exchange allocates them at each call.

Every copy of a refresh, a pack or an unpack is one batched copy
(``kernels/halo_copy.py``): on the card one launch for all its slabs, on
the CPU a ``copy_`` a slab.

Across ranks the transport may ignore tags: NCCL matches the messages
between a pair of ranks in the order they were posted. So every rank posts
its sends and receives in one fixed order (``DistExchange.LON_SENDS``, and
a shift's one send and one receive in ``DistEdges``), which on a 2-wide lon
ring, where both lon neighbours are one rank, pairs each send with the
receive that expects it. A packed send buffer lives until the exchange's
``wait()``: the transfer reads it on its own stream, after the call that
posted it returned.

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

The per-operator halo path of the plain backend (``dist/halo.py``) needs a
one-cell halo at every neighbour shift instead (``dycore/boundaries.py``,
shard mode): ``Edges``, one interface with two implementations beside the
two above:

* ``LocalEdges``: every shard in this process, one thread each, meeting at
  every shift (a rendezvous that checks that the threads run in lockstep,
  aborts them all when one fails, and times out rather than hang);
* ``DistEdges``: one shard per rank; each shift's slab goes to its
  neighbour with ``batch_isend_irecv``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch
import torch.distributed as tdist

from ..kernels.halo_copy import copy_slabs
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

    def use_static_buffers(self):
        """Allocate what the exchanges move through once, for a captured
        step (``DistExchange``; in one process nothing is allocated)."""


class _Done:
    def __init__(self, fn=None):
        self._fn = fn

    def wait(self):
        if self._fn is not None:
            self._fn()


class LocalExchange(Exchange):
    """Every shard of the mesh in this process (local index == shard):
    copies between blocks, every slab of a refresh in one batched copy
    (``kernels/halo_copy.py``)."""

    def refresh_cols(self, fields: list):
        if self.mesh.n_lon == 1:
            return
        pairs = []
        for s, lay in enumerate(self.layouts):
            nb = self.neighbours(lay)
            for side, other in (("west", "east"), ("east", "west")):
                src_lay = self.layouts[nb[side]]
                dst, src = self._col_dst(lay, side), self._col_src(src_lay,
                                                                   other)
                pairs += [(x[..., dst], y[..., src])
                          for x, y in zip(fields[s], fields[nb[side]])]
        copy_slabs(pairs)

    def start_lat(self, fields: list):
        if self.mesh.n_lat == 1:
            return _Done()

        def apply():
            pairs = []
            for s, lay in enumerate(self.layouts):
                nb = self.neighbours(lay)
                for side, other in (("south", "north"), ("north", "south")):
                    if nb[side] is None:
                        continue
                    dst = self._row_dst(lay, side)
                    src = self._row_src(self.layouts[nb[side]], other,
                                        dst.stop - dst.start)
                    pairs += [(x[..., dst, :], y[..., src, :])
                              for x, y in zip(fields[s], fields[nb[side]])]
            copy_slabs(pairs)

        return _Done(apply)

    def all_interiors(self, parts: list) -> list:
        return list(parts)


def _slots(bufs: list, slabs: list):
    """(slot, slab) for each slab of each list of ``slabs``: the slots cut
    one after another from the list's buffer in ``bufs``, in the slabs'
    shapes."""
    for buf, ts in zip(bufs, slabs):
        o = 0
        for t in ts:
            n = t.numel()
            yield buf[o:o + n].view(t.shape), t
            o += n


def _pack_into(bufs: list, sends: list):
    """Each send's source slabs written into its buffer, one after
    another: one batched copy for every buffer."""
    copy_slabs(list(_slots(bufs, [srcs for _, _, srcs in sends])))


def _unpack(bufs: list, recvs: list):
    """Each receive's buffer written into its ghost slabs: one batched copy
    for every buffer."""
    copy_slabs([(g, slot) for slot, g in
                _slots(bufs, [ghosts for _, _, ghosts in recvs])])


@dataclasses.dataclass
class ExchangeClock:
    """What the ghost exchanges across ranks cost this process while it is
    ``DistExchange.clock`` (None, the default: not measured).
    ``exchanges`` counts the exchanges posted (a column refresh, a row
    exchange); ``host_s`` sums the host's seconds inside them (packing and
    posting, then waiting and writing the ghosts). On a card each exchange
    also records CUDA events on the compute stream around its packing and
    around its wait and unpacking: ``device_ms()`` sums those spans, the
    compute stream's time in the exchange that the schedule does not hide
    (under halo overlap the main launches run between the two spans). It
    measures the eager exchange: a captured step's exchanges
    (``use_static_buffers``) read no clock and record no event."""

    exchanges: int = 0
    host_s: float = 0.0
    spans: list = dataclasses.field(default_factory=list)

    def mark(self, dev: torch.device):
        """An event recorded now on ``dev``'s current stream (None on the
        CPU)."""
        if dev.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def device_ms(self):
        """The spans' device ms summed (waits for them to end); None where
        none was recorded (on the CPU)."""
        if not self.spans:
            return None
        total = 0.0
        for e0, e1 in self.spans:
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total


class DistExchange(Exchange):
    """One shard per rank of ``torch.distributed`` (NCCL on the card, gloo
    on the CPU)."""

    # the order in which every rank posts its column sends; it receives
    # from the west, then from the east. On a 2-wide ring this pairs the
    # east-bound send with the neighbour's receive from its west.
    LON_SENDS = ("east", "west")
    clock = None            # an ExchangeClock while one is measuring
    static = None           # the buffers of each exchange, once allocated

    def use_static_buffers(self):
        """From now on, every exchange packs into and unpacks from buffers
        allocated at its first call, keyed by its peers, tags and slab
        shapes, so that a captured step replays the same addresses. The
        exchange clock measures the eager exchange only: these exchanges
        read no clock and record no event."""
        if self.static is None:
            self.static = {}

    def _buffers(self, sends: list, recvs: list) -> list:
        """A buffer for each send and each receive, sized to its slabs:
        new ones, or those of the static buffers kept for these peers,
        tags and shapes."""
        key = None
        if self.static is not None:
            key = (len(sends),) + tuple(
                (peer, tag, tuple(tuple(t.shape) for t in slabs))
                for peer, tag, slabs in sends + recvs)
            if key in self.static:
                return self.static[key]
        x = (sends or recvs)[0][2][0]
        bufs = [torch.empty(sum(t.numel() for t in slabs), dtype=x.dtype,
                            device=x.device)
                for _, _, slabs in sends + recvs]
        if key is not None:
            self.static[key] = bufs
        return bufs

    def _exchange(self, sends: list, recvs: list):
        """Post one exchange. ``sends``: (peer, tag, source slabs);
        ``recvs``: (peer, tag, ghost slabs); each goes packed in one
        buffer, posted in list order (the module docstring). Returns a
        handle whose ``wait()`` writes the ghosts."""
        clock = self.clock if self.static is None else None
        if clock is not None:
            dev = (sends or recvs)[0][2][0].device
            t0, e0 = time.perf_counter(), clock.mark(dev)
        bufs = self._buffers(sends, recvs)
        out, into = bufs[:len(sends)], bufs[len(sends):]
        _pack_into(out, sends)
        ops = [tdist.P2POp(tdist.isend, buf, peer, tag=tag)
               for buf, (peer, tag, _) in zip(out, sends)]
        ops += [tdist.P2POp(tdist.irecv, buf, peer, tag=tag)
                for buf, (peer, tag, _) in zip(into, recvs)]
        reqs = tdist.batch_isend_irecv(ops) if ops else []
        if clock is not None:
            clock.exchanges += 1
            if e0 is not None:
                clock.spans.append((e0, clock.mark(dev)))
            clock.host_s += time.perf_counter() - t0

        def apply():
            # ``ops`` holds the packed send buffers until the transfer has
            # been waited for: freed earlier, the caching allocator could
            # hand their memory to a launch on the compute stream while
            # the transfer still reads it on its own
            if clock is not None:
                t1, e1 = time.perf_counter(), clock.mark(dev)
            for r in reqs:
                r.wait()
            _unpack(into, recvs)
            ops.clear()
            if clock is not None:
                if e1 is not None:
                    clock.spans.append((e1, clock.mark(dev)))
                clock.host_s += time.perf_counter() - t1

        return _Done(apply)

    def refresh_cols(self, fields: list):
        if self.mesh.n_lon == 1:
            return
        (xs,), lay = fields, self.layouts[self.mesh.rank]
        nb = self.neighbours(lay)
        # east-bound data (tag _EAST) fills the east neighbour's west
        # ghosts, west-bound data (_WEST) the west neighbour's east ghosts
        tags = {"east": _EAST, "west": _WEST}
        sends = [(nb[side], tags[side], [x[..., self._col_src(lay, side)]
                                         for x in xs])
                 for side in self.LON_SENDS]
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


# ---------------------------------------------------------------------------
# One-cell halos of the shift primitives (dist/halo.py)
# ---------------------------------------------------------------------------

# the direction the data of a shift travels, by the side it comes from
_TRAVELS = {"west": _EAST, "east": _WEST, "south": _NORTH, "north": _SOUTH}
_OPPOSITE = {"west": "east", "east": "west", "south": "north",
             "north": "south"}
# seconds a shard thread waits for the others at a rendezvous
RENDEZVOUS_TIMEOUT_S = 120.0


class LockstepError(RuntimeError):
    """The shard threads of one process left lockstep: at the same
    rendezvous they ran different shifts, or shifts of different shapes."""


class Aborted(Exception):
    """Another shard thread failed; this one stops (its error is not the
    run's)."""


def _show(key) -> str:
    op, shape = key
    return f"{op} on {shape}" if shape else op


class Edges:
    """What a shift primitive under shard mode needs: ``swap(shard, key,
    side, slab)`` posts ``shard``'s edge ``slab`` and returns the slab that
    the neighbour on ``side`` posted for the same shift (None past a chain
    end). ``key`` names the shift (primitive, shape of its operand).
    ``shifts[shard]`` counts the shifts a shard made."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.shifts = [0] * mesh.size

    def neighbour(self, shard: int, side: str):
        """The shard on ``side``: the lon ring always, the lat chain where
        it goes on (None at a polar end)."""
        a, b = self.mesh.index(shard)
        if side in ("west", "east"):
            return self.mesh.shard(a, b - 1 if side == "west" else b + 1)
        a += -1 if side == "south" else 1
        return self.mesh.shard(a, b) if 0 <= a < self.mesh.n_lat else None

    def swap(self, shard: int, key, side: str, slab):
        raise NotImplementedError

    def finish(self, shard: int):
        """``shard`` has run to its end."""


class LocalEdges(Edges):
    """Every shard in this process, one thread each. At each shift every
    thread posts its slab and its shift's key in a slot, waits on a barrier,
    checks that its key is shard 0's, and reads its neighbour's slot. The
    slots alternate between two sets, so that a slot is written again only
    after the next barrier, which no thread passes before every thread has
    read the last shift's slots. ``finish`` is a rendezvous too, so that a
    thread that ends early is caught. A thread that fails calls ``fail``:
    the barrier is aborted, every other thread raises ``Aborted`` at its
    next wait, and ``error`` holds the first failure. A wait longer than
    ``timeout`` seconds raises ``TimeoutError``. ``waited[shard]`` sums the
    seconds a shard's thread spent waiting at the barrier.

    On a card all threads enqueue on one stream, so the order of enqueue,
    which the barriers fix, is the order of execution."""

    def __init__(self, mesh: Mesh, timeout: float = RENDEZVOUS_TIMEOUT_S):
        super().__init__(mesh)
        n = mesh.size
        self.timeout = timeout
        self.error = None
        self._barrier = threading.Barrier(n)
        self._slots = ([None] * n, [None] * n)
        self._meets = [0] * n
        self._lock = threading.Lock()
        self.waited = [0.0] * n

    def swap(self, shard: int, key, side: str, slab):
        slots = self._meet(shard, key, slab)
        self.shifts[shard] += 1
        nb = self.neighbour(shard, side)
        return None if nb is None else slots[nb][1]

    def finish(self, shard: int):
        self._meet(shard, ("end of run", ()), None)

    def _meet(self, shard: int, key, slab) -> list:
        k = self._meets[shard]
        self._meets[shard] = k + 1
        slots = self._slots[k & 1]
        slots[shard] = (key, slab)
        t0 = time.perf_counter()
        try:
            self._barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            if self.error is not None:
                raise Aborted() from None
            raise TimeoutError(
                f"shard {shard} waited more than {self.timeout} s for the "
                f"other shards at rendezvous {k} ({_show(key)})") from None
        self.waited[shard] += time.perf_counter() - t0
        lead = slots[0][0]
        if key != lead:
            raise LockstepError(
                f"shards out of lockstep at rendezvous {k}: shard {shard} "
                f"runs {_show(key)}, shard 0 runs {_show(lead)}")
        return slots

    def fail(self, exc: BaseException):
        """Record ``exc`` if it is the first failure; abort the barrier."""
        with self._lock:
            if self.error is None:
                self.error = exc
        self._barrier.abort()


class DistEdges(Edges):
    """One shard per rank of ``torch.distributed``: each shift sends this
    rank's slab to the neighbour opposite ``side`` and receives the slab of
    the neighbour on ``side``, tagged by the direction the data travels (on
    a lon ring of 2 both neighbours are one rank)."""

    def swap(self, shard: int, key, side: str, slab):
        self.shifts[shard] += 1
        src = self.neighbour(shard, side)
        dst = self.neighbour(shard, _OPPOSITE[side])
        tag = _TRAVELS[side]
        ops, buf = [], None
        if dst is not None:
            ops.append(tdist.P2POp(tdist.isend, slab.contiguous(), dst,
                                   tag=tag))
        if src is not None:
            buf = torch.empty(slab.shape, dtype=slab.dtype,
                              device=slab.device)
            ops.append(tdist.P2POp(tdist.irecv, buf, src, tag=tag))
        # a lat shift on a mesh of one lat shard has neither
        for req in tdist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return buf


def make_edges(mesh: Mesh) -> Edges:
    return DistEdges(mesh) if mesh.distributed else LocalEdges(mesh)
