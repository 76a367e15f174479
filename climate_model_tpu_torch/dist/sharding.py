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
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core.state import Forcing, State
from .mesh import Mesh

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
