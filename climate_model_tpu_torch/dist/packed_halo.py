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
the schedule and its arithmetic are the same as across ranks.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import ModelConfig, check_rad_resolved
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore.stepper import check_pallas
from ..kernels.fused_substep import corrector, predictor
from ..physics.radiation import radiation_step
from . import sharding
from .mesh import make_mesh, validate_divisibility
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
    [r0, r1) (the second-to-last axis), contiguous."""
    return dataclasses.replace(
        obj, **{f: getattr(obj, f)[..., r0:r1, :].contiguous()
                for f in fields})


def _grid_rows(g: Grid, r0: int, r1: int) -> Grid:
    kw = {f: getattr(g, f)[r0:r1] for f in sharding._GRID_LAT_FIELDS}
    return g.replace(ny=r1 - r0, **kw)


def _splice(dst, src, d0: int, s0: int, n: int, fields):
    for f in fields:
        getattr(dst, f)[..., d0:d0 + n, :].copy_(
            getattr(src, f)[..., s0:s0 + n, :])


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

    def cut(self, state: State) -> State:
        return _rows(state, self.r0, self.r1, STATE_FIELDS)

    def merge(self, out: State, strip_out: State, fields):
        d0, s0, n = self.keep
        _splice(out, strip_out, d0, s0, n, fields)


def make_packed_sharded_runner(cfg: ModelConfig, n_steps: int = 1):
    """``run(state, grid, forcing)`` advancing ``n_steps`` on the mesh of
    ``cfg``. ``state`` is a ``ShardedState`` (``dist.sharding.shard``; its
    blocks carry the geometry and forcing cut for them, and ``grid``
    supplies only ``dt``), and ``run`` returns one; or a global ``State``,
    which ``run`` splits over the mesh of ``make_mesh(cfg)`` on its device
    and gathers back."""
    check_rad_resolved(cfg)
    check_pallas(cfg)
    num, phys = cfg.numerics, cfg.physics
    from ..model import phys_epilogue_tuple
    phys_tuple = phys_epilogue_tuple(cfg)
    kw = dict(with_rad=phys.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    sh = cfg.sharding
    overlap = bool(sh.halo_overlap) and sh.mesh_lat > 1
    corr_fields = DYN_FIELDS + (EPI_FIELDS if phys_tuple is not None else ())

    def check(ss: ShardedState):
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
        if overlap and lay.ny_l < ss.halo.south + ss.halo.north:
            raise ValueError(
                f"halo_overlap needs ny/mesh_lat >= "
                f"{ss.halo.south + ss.halo.north} rows per shard (got "
                f"{lay.ny_l})")

    def run_blocks(ss: ShardedState, dt: float) -> ShardedState:
        check(ss)
        ex = ss.exchange
        grids = [g.replace(dt=dt) for g in ss.grids]
        masks = [row_mask(lay, s.dtype, s.device)
                 for lay, s in zip(ss.layouts, ss.states)]
        shard_kw = [dict(kw, vmask=m, part="shard") for m in masks]
        strips = []
        if overlap:
            for lay, g, f, m in zip(ss.layouts, grids, ss.forcings, masks):
                strips.append([SeamStrip(side, lay, g, f, m, ss.halo)
                               for side, has in (("south", lay.gs),
                                                 ("north", lay.gn)) if has])
        # the blocks are refreshed in place: start from copies
        states = [s.replace(**{f: getattr(s, f).clone()
                               for f in STATE_FIELDS}) for s in ss.states]
        per_shard = list(zip(grids, ss.forcings, shard_kw))

        def fields(blocks, names):
            return [[getattr(b, f) for f in names] for b in blocks]

        def predict(blocks):
            return [predictor(s, g, f, dt, **skw)
                    for s, (g, f, skw) in zip(blocks, per_shard)]

        def correct(p, blocks):
            return [corrector(pi, s, g, f, dt, phys=phys_tuple, **skw)
                    for pi, s, (g, f, skw) in zip(p, blocks, per_shard)]

        def seams(fn, outs, names, *blocks, **k):
            """``fn`` on every seam strip of ``blocks``, its rows spliced
            over ``outs`` (which no strip reads)."""
            for i, strips_i in enumerate(strips):
                skw = per_shard[i][2]
                for st in strips_i:
                    res = fn(*(st.cut(b[i]) for b in blocks), st.grid,
                             st.forcing, dt, **dict(skw, vmask=st.vmask,
                                                    part=st.part, **k))
                    st.merge(outs[i], res, names)

        for _ in range(n_steps):
            if phys.radiation:
                states = [radiation_step(s, g, f, cfg)
                          for s, (g, f, _) in zip(states, per_shard)]
            prog = fields(states, PROG_FIELDS + RAD_FIELDS)
            if not overlap:
                ex.refresh(prog)
                p = predict(states)
                ex.refresh(fields(p, DYN_FIELDS))
                out = correct(p, states)
            else:
                # the main launches read stale lat ghost rows while the
                # exchange is in flight; the strips redo the rows they reach
                ex.refresh_cols(prog)
                pending = ex.start_lat(prog)
                p = predict(states)
                pending.wait()
                seams(predictor, p, DYN_FIELDS, states)
                ex.refresh_cols(fields(p, DYN_FIELDS))
                pending = ex.start_lat(fields(p, DYN_FIELDS))
                out = correct(p, states)
                pending.wait()
                seams(corrector, out, corr_fields, p, states, phys=phys_tuple)
            states = [o.replace(t=o.t + dt, step=o.step + 1) for o in out]
        return ss.replace(states=tuple(states))

    def run(state, grid: Grid, forcing: Forcing = None):
        if isinstance(state, ShardedState):
            return run_blocks(state, grid.dt)
        mesh = make_mesh(cfg, device=state.device)
        ss = sharding.shard(mesh, state, grid, forcing)
        return sharding.gather(run_blocks(ss, grid.dt))

    return run
