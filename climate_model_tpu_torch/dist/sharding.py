"""Shard blocks: where each shard's block lies, and the split and gather of
``State``, ``Forcing`` and ``Grid``.

Port of ``climate_model_tpu/dist/sharding.py``, whose PartitionSpec tables
it follows: 3-D fields ``(nz, ny, nx)`` and 2-D fields ``(ny, nx)`` split by
(lat, lon), the ``_GRID_LAT_FIELDS`` by lat, the ``_GRID_LON_FIELDS`` by
lon, per-level geometry and scalars replicated. The reference splits into
packed supertensors; the port's blocks are plain ``State`` fields.

A shard's block carries ``HALO`` ghost rows on its south side and
``HALO_N`` on its north side where it has a lat neighbour, and ``GX`` ghost
columns on each side when the mesh has more than one shard in longitude. A
side at a polar wall carries none, so that the kernels' own wall rule runs
there as on one device. The radii are the reference's
(``climate_model_tpu/kernels/fused_substep.py:88-102``); the header of
``kernels/csrc/fused_substep.cu`` works out why 3 suffices for the port's
three launches. Static fields (forcing, per-latitude geometry) get their
ghost rows and columns from the global arrays once, when they are split.
The plain backend's per-operator halo path (``dist/halo.py``) runs on
ghost-free blocks (``Halo(0, 0, 0)``).

GSPMD ``auto`` across ranks runs the global program on
``torch.distributed.tensor.DTensor``s (``to_dtensors``/``from_dtensors``):
each rank's ghost-free block becomes its local shard of a DTensor over a
``DeviceMesh`` with dims ``("lat", "lon")``, placed by the same tables.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from .mesh import Mesh, make_mesh, validate_divisibility

HALO = 3        # ghost rows on a block's south side
HALO_N = 3      # ghost rows on its north side
GX = 3          # ghost columns on each side (meshes with n_lon > 1)

_GRID_LAT_FIELDS = {"lat", "lats", "dx", "dxs", "area", "area_u", "area_v",
                    "corf", "corf_v", "tan_lat", "tan_lat_v",
                    "kdiff_uv", "kdiff_pott", "kdiff_moist"}
_GRID_LON_FIELDS = {"lon", "lonu"}
STATE_FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
                "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc")


@dataclasses.dataclass(frozen=True)
class Halo:
    """Ghost widths: rows south and north, columns on each side."""

    south: int = HALO
    north: int = HALO_N
    cols: int = GX


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one shard's block lies in the global ``(ny, nx)`` grid."""

    lat_idx: int
    lon_idx: int
    ny: int          # global extents
    nx: int
    ny_l: int        # interior extents
    nx_l: int
    gs: int          # ghost rows present: south, north; ghost columns
    gn: int
    gx: int

    @property
    def ny_b(self) -> int:
        return self.gs + self.ny_l + self.gn

    @property
    def nx_b(self) -> int:
        return self.nx_l + 2 * self.gx

    @property
    def y0(self) -> int:
        """Global row of block row 0."""
        return self.lat_idx * self.ny_l - self.gs

    @property
    def x0(self) -> int:
        """Global column of block column 0 (mod nx)."""
        return self.lon_idx * self.nx_l - self.gx

    @property
    def whole_circle(self) -> bool:
        """The block is a whole latitude circle (one shard in lon)."""
        return self.nx_l == self.nx

    @property
    def rows(self) -> slice:
        """The interior rows, in block coordinates."""
        return slice(self.gs, self.gs + self.ny_l)

    @property
    def cols(self) -> slice:
        """The interior columns, in block coordinates."""
        return slice(self.gx, self.gx + self.nx_l)


def layout(mesh: Mesh, shard: int, ny: int, nx: int,
           halo: Halo = Halo()) -> Layout:
    lat_idx, lon_idx = mesh.index(shard)
    return Layout(lat_idx=lat_idx, lon_idx=lon_idx, ny=ny, nx=nx,
                  ny_l=ny // mesh.n_lat, nx_l=nx // mesh.n_lon,
                  gs=halo.south if lat_idx > 0 else 0,
                  gn=halo.north if lat_idx < mesh.n_lat - 1 else 0,
                  gx=halo.cols if mesh.n_lon > 1 else 0)


def _cut_rows(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    return x[..., lay.y0:lay.y0 + lay.ny_b, :]


def _cut_cols(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    if lay.whole_circle:
        return x
    idx = torch.arange(lay.x0, lay.x0 + lay.nx_b, device=x.device) % lay.nx
    return x.index_select(-1, idx)


def split(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The block of a global ``(..., ny, nx)`` field, ghosts included, as a
    new contiguous tensor."""
    return _cut_cols(_cut_rows(x, lay), lay).clone(
        memory_format=torch.contiguous_format)


def split_state(state: State, lay: Layout) -> State:
    return state.replace(**{f: split(getattr(state, f), lay)
                            for f in STATE_FIELDS})


def split_forcing(forcing: Forcing, lay: Layout) -> Forcing:
    return Forcing(**{f.name: split(getattr(forcing, f.name), lay)
                      for f in dataclasses.fields(Forcing)})


def split_grid(grid: Grid, lay: Layout) -> Grid:
    kw = {}
    for name in _GRID_LAT_FIELDS:
        kw[name] = getattr(grid, name)[lay.y0:lay.y0 + lay.ny_b].contiguous()
    for name in _GRID_LON_FIELDS:
        kw[name] = _cut_cols(getattr(grid, name), lay).contiguous()
    return grid.replace(ny=lay.ny_b, nx=lay.nx_b, **kw)


def interior(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The interior of a block field, without its ghosts (a view)."""
    return x[..., lay.rows, lay.cols]


def assemble(parts: list, lays: list) -> torch.Tensor:
    """The global field from the interiors of every shard (shard order)."""
    n_lon = lays[0].nx // lays[0].nx_l
    rows = [torch.cat(parts[a * n_lon:(a + 1) * n_lon], dim=-1)
            for a in range(len(parts) // n_lon)]
    return torch.cat(rows, dim=-2).contiguous()


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """The blocks of the shards this process owns, with what was cut once
    for them: their layouts, geometry and forcing. ``exchange`` moves ghost
    rows and columns and gathers interiors (``dist/comm.py``)."""

    mesh: Mesh
    halo: Halo
    layouts: tuple          # Layout of each local shard
    states: tuple           # State block of each local shard
    grids: tuple            # Grid block (dt is set by the runner)
    forcings: tuple         # Forcing block
    exchange: object        # dist.comm.Exchange

    def replace(self, **kw) -> "ShardedState":
        return dataclasses.replace(self, **kw)


def shard(mesh: Mesh, state: State, grid: Grid, forcing: Forcing,
          halo: Halo = Halo()) -> ShardedState:
    """Split the global ``state``, ``grid`` and ``forcing`` into the blocks
    of the shards this process owns."""
    from .comm import make_exchange

    lays_all = [layout(mesh, s, grid.ny, grid.nx, halo)
                for s in range(mesh.size)]
    lays = tuple(lays_all[s] for s in mesh.local_shards)
    return ShardedState(
        mesh=mesh, halo=halo, layouts=lays,
        states=tuple(split_state(state, lay) for lay in lays),
        grids=tuple(split_grid(grid, lay) for lay in lays),
        forcings=tuple(split_forcing(forcing, lay) for lay in lays),
        exchange=make_exchange(mesh, lays_all))


def gather(ss: ShardedState) -> State:
    """The global State from the interiors of every shard (on every rank
    when the shards are spread over ranks)."""
    first = ss.states[0]
    lays_all = ss.exchange.layouts
    fields = {}
    for f in STATE_FIELDS:
        parts = ss.exchange.all_interiors(
            [interior(getattr(s, f), lay)
             for s, lay in zip(ss.states, ss.layouts)])
        fields[f] = assemble(parts, lays_all)
    return first.replace(**fields)


def global_io(cfg: ModelConfig, run_blocks, halo: Halo):
    """``run(state, grid, forcing)`` over ``run_blocks(ss, dt)``: ``state``
    a ``ShardedState`` (its blocks carry their geometry and forcing;
    ``grid`` supplies only ``dt``), returned as one; or a global ``State``,
    split over the mesh of ``make_mesh(cfg)`` on its device into blocks
    with ghosts ``halo`` and gathered back."""

    def run(state, grid: Grid, forcing: Forcing = None):
        if isinstance(state, ShardedState):
            return run_blocks(state, grid.dt)
        mesh = make_mesh(cfg, device=state.device)
        validate_divisibility(cfg, mesh)
        return gather(run_blocks(shard(mesh, state, grid, forcing, halo),
                                 grid.dt))

    return run


# ---------------------------------------------------------------------------
# GSPMD 'auto' across ranks: the blocks as DTensors
# ---------------------------------------------------------------------------

# the reference's state_pspec: these by (lat, lon), the other fields by
# (None, lat, lon), t and step replicated
_STATE_2D_FIELDS = {"colp", "tsurf", "rain", "soil_moist", "swflx_sfc",
                    "lwflx_sfc"}
_DEVICE_MESHES = {}


def shard_flip_and_roll():
    """Give DTensor a sharding strategy for ``aten.flip`` and ``aten.roll``
    where this PyTorch has none (2.11 has neither; 2.13 has both). The
    plain step flips the levels (``dycore/operators.py::
    diagnose_geopotential``) and rolls the longitudes
    (``dycore/boundaries.py``, ``west``/``east``): along a dim that is not
    sharded either runs on the local shards; a sharded dim that it flips or
    rolls is replicated first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.experimental import register_sharding

    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten

    def placements_of(x, dims, n_args):
        nd = len(x.shape)
        moved = {d % nd for d in dims} if dims else set(range(nd))
        rest = [None] * (n_args - 1)
        return [([Replicate()], [Replicate()] + rest)] + [
            ([Shard(d)], [Shard(d)] + rest)
            for d in range(nd) if d not in moved]

    def flip(x, dims):
        return placements_of(x, dims, 2)

    def roll(x, shifts, *dims):
        return placements_of(x, dims[0] if dims else (), 2 + len(dims))

    for op, fn in ((aten.flip.default, flip), (aten.roll.default, roll)):
        if any(op in getattr(prop, reg, {}) for reg in (
                "op_strategy_funcs", "op_single_dim_strategy_funcs",
                "op_to_rules")):
            continue
        register_sharding(op)(fn)
        # the dims decide the placements: hash them into the strategy cache
        prop.op_to_schema_info[op] = RuntimeSchemaInfo(1, needs_pytree=True)


def device_mesh(mesh: Mesh):
    """The ``DeviceMesh`` of ``mesh``'s ranks, dims ``("lat", "lon")``;
    made once per process group (it makes a group for each dim)."""
    from torch.distributed.device_mesh import init_device_mesh

    key = (mesh.n_lat, mesh.n_lon, mesh.device.type, tdist.group.WORLD)
    if key not in _DEVICE_MESHES:
        shard_flip_and_roll()
        _DEVICE_MESHES[key] = init_device_mesh(
            mesh.device.type, (mesh.n_lat, mesh.n_lon),
            mesh_dim_names=("lat", "lon"))
    return _DEVICE_MESHES[key]


def placements(kind: str, name: str) -> tuple:
    """The DTensor placements (one per mesh dim: lat, lon) of the field
    ``name`` of a ``State``, ``Forcing`` or ``Grid`` (``kind``)."""
    from torch.distributed.tensor import Replicate, Shard

    if kind == "grid":
        if name in _GRID_LAT_FIELDS:
            return (Shard(0), Replicate())
        if name in _GRID_LON_FIELDS:
            return (Replicate(), Shard(0))
        return (Replicate(), Replicate())
    if kind == "state" and name == "t":
        return (Replicate(), Replicate())
    if kind == "forcing" or name in _STATE_2D_FIELDS:
        return (Shard(0), Shard(1))
    return (Shard(1), Shard(2))


def to_dtensors(ss: ShardedState) -> tuple:
    """``(state, grid, forcing)`` of DTensors whose local shards are this
    rank's ghost-free block (no data moves). ``grid`` keeps the block's
    ``dt``."""
    from torch.distributed.tensor import DTensor

    (st,), (g,), (fo,), (lay,) = ss.states, ss.grids, ss.forcings, \
        ss.layouts
    if (lay.gs, lay.gn, lay.gx) != (0, 0, 0):
        raise ValueError("DTensors are made from ghost-free blocks "
                         "(Halo(0, 0, 0))")
    dm = device_mesh(ss.mesh)

    def dt(x, kind, name):
        return DTensor.from_local(x, dm, placements(kind, name),
                                  run_check=False)

    state = st.replace(t=dt(st.t, "state", "t"),
                       **{f: dt(getattr(st, f), "state", f)
                          for f in STATE_FIELDS})
    forcing = Forcing(**{f.name: dt(getattr(fo, f.name), "forcing", f.name)
                         for f in dataclasses.fields(Forcing)})
    grid = g.replace(ny=lay.ny, nx=lay.nx, **{
        f.name: dt(getattr(g, f.name), "grid", f.name)
        for f in dataclasses.fields(Grid)
        if isinstance(getattr(g, f.name), torch.Tensor)})
    return state, grid, forcing


def from_dtensors(ss: ShardedState, state: State) -> ShardedState:
    """``ss`` with this rank's block taken from the DTensor ``state``
    (each field redistributed to its placement first: an op may leave a
    field replicated along a mesh dim)."""
    dm = device_mesh(ss.mesh)

    def local(x, name):
        return x.redistribute(dm, placements("state", name)).to_local() \
            .contiguous()

    block = ss.states[0].replace(t=local(state.t, "t"), step=state.step,
                                 **{f: local(getattr(state, f), f)
                                    for f in STATE_FIELDS})
    return ss.replace(states=(block,))
