"""The substep kernels on a lat-lon mesh: the sharded packed scan.

Port of ``climate_model_tpu/dist/packed_halo.py::make_packed_sharded_runner``
(``:116-295``). Each shard holds a block of the plain ``State`` fields with
ghost rows and columns (``dist/sharding.py``); ghosts are refreshed from the
neighbouring shards between kernel launches (``dist/comm.py``). A step is:

    radiation on its interval, on each block (column-local)
    -> refresh the prognostic and radiative fields     [lon cols, lat rows]
    -> predictor kernel on each block
    -> refresh the predicted fields
    -> corrector kernel with the physics epilogue on each block

The blocks run the shard-local kernel variant: the same launches on a
shard's block, with the v wall from the global row index (``:218-226``) as a
row mask on every block. The lon index wraps within the block, which is wrong
data at its outermost columns, as the reference's ``wrap_lon=False`` clamp
is; the ghost width keeps it out of the interior
(``kernels/csrc/fused_substep.cu``).

**Halo overlap** (``cfg.sharding.halo_overlap`` with more than one shard in
latitude; ``body_overlap``, ``:255-282``): each program launches on the
block with its stale lat ghost rows while the lat exchange is in flight;
then the same program runs on two seam strips cut from the freshly
exchanged rows (``s_in``/``n_in``), and their rows are spliced over the
output rows the stale ghosts reach (``merge``): ``NY_S = HALO`` rows at the
south seam, ``NY_N = HALO_N`` at the north seam. Lon columns stay blocking,
as the reference decided (docstring ``:121-141``). A polar side has no stale
rows, so it gets no strip: at 2x4 a step makes 8 main launches of each
program, and 4 south and 4 north strip launches.

With all shards in one process the exchange is a copy and nothing overlaps;
the schedule and its arithmetic are the same as across ranks. A strip's
cut (of the fields whose rows are not contiguous in the block) and its
splice are each one batched copy (``kernels/halo_copy.py``), as are the
exchange's packs and unpacks (``dist/comm.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import ModelConfig, check_rad_resolved
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore.stepper import check_pallas
from ..kernels.fused_substep import corrector, geo_table, predictor
from ..kernels.halo_copy import copy_slabs
from ..model import phys_epilogue_tuple, run_packed
from . import sharding
from .mesh import validate_divisibility
from .sharding import STATE_FIELDS, ShardedState

DYN_FIELDS = ("u", "v", "pott", "qv", "qc", "colp")     # substep outputs
EPI_FIELDS = ("tsurf", "rain", "soil_moist")            # epilogue's too
PROG_FIELDS = DYN_FIELDS + EPI_FIELDS
RAD_FIELDS = ("dpottdt_rad", "swflx_sfc", "lwflx_sfc")


def row_mask(lay: sharding.Layout, dtype, device):
    """The block's rows of the global v-wall mask: 0 on global row 0 (the
    south wall) and on rows >= ny, 1 elsewhere."""
    grow = lay.y0 + torch.arange(lay.ny_b, device=device)
    return ((grow > 0) & (grow < lay.ny)).to(dtype)


def _rows(obj, r0: int, r1: int, fields):
    """A copy of the dataclass ``obj`` with each of ``fields`` cut to rows
    [r0, r1) (the second-to-last axis), contiguous: a field whose rows are
    contiguous already is a view, as ``.contiguous()`` leaves it, the
    others are copied by one batched copy (``kernels/halo_copy.py``)."""
    cut = {f: getattr(obj, f)[..., r0:r1, :] for f in fields}
    out = {f: x if x.is_contiguous() else torch.empty_like(
        x, memory_format=torch.contiguous_format) for f, x in cut.items()}
    copy_slabs([(out[f], x) for f, x in cut.items() if out[f] is not x])
    return dataclasses.replace(obj, **out)


def _grid_rows(g: Grid, r0: int, r1: int) -> Grid:
    kw = {f: getattr(g, f)[r0:r1] for f in sharding._GRID_LAT_FIELDS}
    return g.replace(ny=r1 - r0, **kw)


def _splice(dst, src, d0: int, s0: int, n: int, fields):
    copy_slabs([(getattr(dst, f)[..., d0:d0 + n, :],
                 getattr(src, f)[..., s0:s0 + n, :]) for f in fields])


class SeamStrip:
    """One seam strip of a block: its rows in the block, the rows of its
    output that replace the main launch's, and its static inputs."""

    def __init__(self, side, lay, grid, forcing, vmask, halo):
        ny_s, ny_n = halo.south, halo.north       # seam widths = the radii
        if side == "south":
            # fresh ghosts + NY_S rows + HALO_N rows of context
            self.r0, self.r1 = 0, lay.gs + ny_s + halo.north
            self.keep = (0, 0, lay.gs + ny_s)      # (block row, strip row, n)
        else:
            # HALO rows of context + NY_N rows + fresh ghosts
            self.r0 = lay.gs + lay.ny_l - ny_n - halo.south
            self.r1 = lay.ny_b
            n = ny_n + lay.gn
            self.keep = (lay.ny_b - n, self.r1 - self.r0 - n, n)
        self.part = f"{side}_strip"
        self.grid = _grid_rows(grid, self.r0, self.r1)
        self.forcing = _rows(forcing, self.r0, self.r1,
                             [f.name for f in dataclasses.fields(Forcing)])
        self.vmask = vmask[self.r0:self.r1].contiguous()
        self.geo = None            # its geometry table, on a captured step

    def cut(self, state: State) -> State:
        return _rows(state, self.r0, self.r1, STATE_FIELDS)

    def merge(self, out: State, strip_out: State, fields):
        d0, s0, n = self.keep
        _splice(out, strip_out, d0, s0, n, fields)


class ShardStep:
    """One step of the sharded packed scan on the blocks of a
    ``ShardedState`` ``ss``, the mesh's implementation of the packed-scan
    step (``model.py``; ``model.PackedStep`` is the one-device one), without
    the time bookkeeping: ``step(states, radiation, *, scalars=None,
    outs=None)`` takes the blocks' time-n ``State``s (their ghosts are
    refreshed in place) and returns the corrector's outputs. ``radiation(i,
    state)`` is shard ``i``'s radiation on its interval. It needs no
    buffers beyond the blocks'.

    The eager loop (``model.run_packed``) makes one a chunk. A captured
    step (``graphs.py``) makes one at capture with ``static=True``, which
    computes each block's and strip's geometry table once, and calls it
    with ``scalars`` (the ``(dt, frac)`` operand) and ``outs`` (per shard,
    the tensors that the corrector writes)."""

    def __init__(self, cfg: ModelConfig, ss: ShardedState, dt: float,
                 static: bool = False):
        num, phys = cfg.numerics, cfg.physics
        self.cfg, self.dt, self.exchange = cfg, dt, ss.exchange
        self.phys = phys_epilogue_tuple(cfg)
        kw = dict(with_rad=phys.radiation,
                  with_diff=bool(num.diff_uv or num.diff_pott
                                 or num.diff_moist))
        sh = cfg.sharding
        self.overlap = bool(sh.halo_overlap) and sh.mesh_lat > 1
        self.corr_fields = DYN_FIELDS + (EPI_FIELDS if self.phys is not None
                                         else ())
        self.grids = [g.replace(dt=dt) for g in ss.grids]
        self.forcings = ss.forcings
        masks = [row_mask(lay, s.dtype, s.device)
                 for lay, s in zip(ss.layouts, ss.states)]
        self.shard_kw = [dict(kw, vmask=m, part="shard") for m in masks]
        self.strips = []
        if self.overlap:
            for lay, g, f, m in zip(ss.layouts, self.grids, ss.forcings,
                                    masks):
                self.strips.append(
                    [SeamStrip(side, lay, g, f, m, ss.halo)
                     for side, has in (("south", lay.gs),
                                       ("north", lay.gn)) if has])
        if static:
            for g, skw in zip(self.grids, self.shard_kw):
                skw["geo"] = geo_table(g)
            for strips_i in self.strips:
                for st in strips_i:
                    st.geo = geo_table(st.grid)

    def __call__(self, states: list, radiation, *, scalars=None,
                 outs: list | None = None) -> list:
        dt, ex, phys_tuple = self.dt, self.exchange, self.phys
        per_shard = list(zip(self.grids, self.forcings, self.shard_kw))

        def fields(blocks, names):
            return [[getattr(b, f) for f in names] for b in blocks]

        def predict(blocks):
            return [predictor(s, g, f, dt, scalars=scalars, **skw)
                    for s, (g, f, skw) in zip(blocks, per_shard)]

        def correct(p, blocks):
            return [corrector(pi, s, g, f, dt, phys=phys_tuple,
                              scalars=scalars,
                              out=None if outs is None else outs[i], **skw)
                    for i, (pi, s, (g, f, skw)) in enumerate(
                        zip(p, blocks, per_shard))]

        def seams(fn, res, names, *blocks, **k):
            """``fn`` on every seam strip of ``blocks``, its rows spliced
            over ``res`` (which no strip reads)."""
            for i, strips_i in enumerate(self.strips):
                skw = per_shard[i][2]
                for st in strips_i:
                    out = fn(*(st.cut(b[i]) for b in blocks), st.grid,
                             st.forcing, dt, **dict(skw, vmask=st.vmask,
                                                    part=st.part, geo=st.geo,
                                                    scalars=scalars, **k))
                    st.merge(res[i], out, names)

        if self.cfg.physics.radiation:
            states = [radiation(i, s) for i, s in enumerate(states)]
        prog = fields(states, PROG_FIELDS + RAD_FIELDS)
        if not self.overlap:
            ex.refresh(prog)
            p = predict(states)
            ex.refresh(fields(p, DYN_FIELDS))
            return correct(p, states)
        # the main launches read stale lat ghost rows while the exchange
        # is in flight; the strips redo the rows they reach
        ex.refresh_cols(prog)
        pending = ex.start_lat(prog)
        p = predict(states)
        pending.wait()
        seams(predictor, p, DYN_FIELDS, states)
        ex.refresh_cols(fields(p, DYN_FIELDS))
        pending = ex.start_lat(fields(p, DYN_FIELDS))
        out = correct(p, states)
        pending.wait()
        seams(corrector, out, self.corr_fields, p, states, phys=phys_tuple)
        return out


def check_blocks(cfg: ModelConfig, ss: ShardedState):
    """Raise where the blocks of ``ss`` do not fit the mesh, dtype and
    schedule of ``cfg``."""
    sh = cfg.sharding
    mesh = ss.mesh
    if (mesh.n_lat, mesh.n_lon) != (sh.mesh_lat, sh.mesh_lon):
        raise ValueError(f"blocks of a {mesh.n_lat}x{mesh.n_lon} mesh, "
                         f"config {sh.mesh_lat}x{sh.mesh_lon}")
    validate_divisibility(cfg, mesh)
    dev = ss.states[0].device
    if dev.type == "cuda" and cfg.dtype != "float32":
        raise ValueError("backend='pallas' runs float32 on the card; "
                         "float64 runs on the CPU (the plain versions)")
    lay = ss.layouts[0]
    if (bool(sh.halo_overlap) and sh.mesh_lat > 1
            and lay.ny_l < ss.halo.south + ss.halo.north):
        raise ValueError(
            f"halo_overlap needs ny/mesh_lat >= "
            f"{ss.halo.south + ss.halo.north} rows per shard (got "
            f"{lay.ny_l})")


def make_packed_sharded_runner(cfg: ModelConfig, n_steps: int = 1):
    """``run(state, grid, forcing)`` advancing ``n_steps`` of the eager
    loop (``model.run_packed``) on a ``ShardStep`` over the mesh of
    ``cfg``. ``state`` is a ``ShardedState`` (``dist.sharding.shard``; its
    blocks carry the geometry and forcing cut for them, and ``grid``
    supplies only ``dt``), and ``run`` returns one; or a global ``State``,
    which ``run`` splits over the mesh of ``make_mesh(cfg)`` on its device
    and gathers back."""
    check_rad_resolved(cfg)
    check_pallas(cfg)

    def run_blocks(ss: ShardedState, dt: float) -> ShardedState:
        check_blocks(cfg, ss)
        # the blocks are refreshed in place: start from copies
        states = [s.replace(**{f: getattr(s, f).clone()
                               for f in STATE_FIELDS}) for s in ss.states]
        return ss.replace(states=tuple(run_packed(
            cfg, ShardStep(cfg, ss, dt), states, dt, n_steps)))

    return sharding.global_io(cfg, run_blocks, sharding.Halo())
