"""Frozen copy of ``climate_model_tpu_torch/core/grid.py`` at commit dbbffa0
(the benchmark's plain reference; imports nothing of the port).

Grid geometry: staggered lat-lon horizontal grid + sigma vertical coordinate.

Port of ``climate_model_tpu/core/grid.py``. Storage convention (unchanged):

  * scalars (COLP, POTT, QV, QC): cell centers ``(j, i)``;
  * UWIND ``u[k, j, i]`` at the WEST face of cell ``(j, i)``, periodic in
    longitude (the east face of cell ``nx-1`` is ``u[..., 0]``);
  * VWIND ``v[k, j, i]`` at the SOUTH face of cell ``(j, i)``; rigid walls
    at ``lat0``/``lat1``: ``v[:, 0, :] == 0`` and the north wall face is not
    stored;
  * ``nz`` sigma layers with borders ``k = 0..nz`` (0 at model top).

The geometry is built once on the host in float64 NumPy and cast once to the
working dtype on the requested device. Two scalars, ``dy`` and ``dt``, are
host floats (rounded to the working dtype) rather than 0-d tensors: the
substep kernel takes them as launch arguments, and a host float needs no
device read before each launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as c
from .config import GridConfig, NumericsConfig


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static geometry. 1-D tensors are per-latitude unless noted."""

    lat: torch.Tensor        # (ny,)   cell-center latitude [rad]
    lats: torch.Tensor       # (ny,)   south-face (v-row) latitude [rad]
    lon: torch.Tensor        # (nx,)   cell-center longitude [rad]
    lonu: torch.Tensor       # (nx,)   u-face longitude [rad]
    dx: torch.Tensor         # (ny,)   zonal spacing at cell centers [m]
    dxs: torch.Tensor        # (ny,)   zonal spacing at v faces (south) [m]
    dy: float                # meridional spacing [m] (host float)
    area: torch.Tensor       # (ny,)   exact spherical cell area [m2]
    area_u: torch.Tensor     # (ny,)   u-cell area [m2]
    area_v: torch.Tensor     # (ny,)   v-cell area at south faces, row 0 = wall
    corf: torch.Tensor       # (ny,)   Coriolis parameter at centers [s-1]
    corf_v: torch.Tensor     # (ny,)   Coriolis at v rows [s-1]
    tan_lat: torch.Tensor    # (ny,)   tan(lat) at centers
    tan_lat_v: torch.Tensor  # (ny,)   tan(lat) at v rows
    sigma_vb: torch.Tensor   # (nz+1,) sigma at level borders, 0..1
    sigma: torch.Tensor      # (nz,)   sigma at level centers
    dsigma: torch.Tensor     # (nz,)   border-to-border sigma thickness
    dt: float                # model timestep [s] (host float)
    kdiff_uv: torch.Tensor     # (ny,) horizontal diffusivities [m2 s-1]
    kdiff_pott: torch.Tensor   # (ny,)
    kdiff_moist: torch.Tensor  # (ny,)
    nx: int
    ny: int
    nz: int
    ptop: float

    def replace(self, **kw) -> "Grid":
        return dataclasses.replace(self, **kw)


def round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` and returned as a host float."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def adaptive_cfl_dt(min_dx: float, cfl: float, max_wind: float) -> float:
    """dt from the CFL bound at the current max wind: external-gravity-wave
    speed sqrt(g*H) plus the advective margin, which never drops below the
    100 m/s used at init (so dt only shrinks below its init value)."""
    c_grav = float(np.sqrt(c.G * 10_000.0))
    return float(cfl) * float(min_dx) / (c_grav + max(float(max_wind), 100.0))


def make_grid(cfg: GridConfig, num: NumericsConfig | None = None,
              dtype=torch.float32, device="cuda", np_mode: bool = False):
    """Build the grid geometry.

    With ``np_mode=True`` returns a namespace-like ``Grid`` of float64 NumPy
    arrays (for initial conditions and the oracle); otherwise tensors at
    ``dtype`` on ``device``.
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    lat0 = np.deg2rad(cfg.lat0_deg)
    lat1 = np.deg2rad(cfg.lat1_deg)
    lon0 = np.deg2rad(cfg.lon0_deg)
    lon1 = np.deg2rad(cfg.lon1_deg)

    dlat = (lat1 - lat0) / ny
    dlon = (lon1 - lon0) / nx

    faces = lat0 + dlat * np.arange(ny + 1)
    lats = faces[:-1]
    lat = 0.5 * (faces[:-1] + faces[1:])
    lonu = lon0 + dlon * np.arange(nx)
    lon = lonu + 0.5 * dlon

    dy = c.R_EARTH * dlat
    dx = c.R_EARTH * dlon * np.cos(lat)
    dxs = c.R_EARTH * dlon * np.cos(lats)

    area = c.R_EARTH**2 * dlon * (np.sin(faces[1:]) - np.sin(faces[:-1]))
    area_u = area.copy()
    area_v = np.empty(ny)
    area_v[1:] = c.R_EARTH**2 * dlon * (np.sin(lat[1:]) - np.sin(lat[:-1]))
    area_v[0] = area[0]

    corf = 2.0 * c.OMEGA * np.sin(lat)
    corf_v = 2.0 * c.OMEGA * np.sin(lats)
    tan_lat = np.tan(lat)
    tan_lat_v = np.tan(lats)

    x = np.linspace(0.0, 1.0, nz + 1)
    sigma_vb = x ** float(getattr(cfg, "sigma_stretch", 1.0))
    sigma = 0.5 * (sigma_vb[:-1] + sigma_vb[1:])
    dsigma = np.diff(sigma_vb)

    num = num or NumericsConfig()
    ones_y = np.ones(ny)
    kdiff_uv = num.diff_uv * ones_y
    kdiff_pott = num.diff_pott * ones_y
    kdiff_moist = num.diff_moist * ones_y

    if num.dt is not None:
        dt = float(num.dt)
    else:
        dt = adaptive_cfl_dt(float(min(dx.min(), dy)), num.cfl, 100.0)

    arrays = dict(
        lat=lat, lats=lats, lon=lon, lonu=lonu, dx=dx, dxs=dxs,
        area=area, area_u=area_u, area_v=area_v,
        corf=corf, corf_v=corf_v, tan_lat=tan_lat, tan_lat_v=tan_lat_v,
        sigma_vb=sigma_vb, sigma=sigma, dsigma=dsigma,
        kdiff_uv=kdiff_uv, kdiff_pott=kdiff_pott, kdiff_moist=kdiff_moist,
    )
    if np_mode:
        arrays = {k: np.asarray(v, np.float64) for k, v in arrays.items()}
        return Grid(nx=nx, ny=ny, nz=nz, ptop=cfg.ptop,
                    dy=np.float64(dy), dt=np.float64(dt), **arrays)
    arrays = {k: torch.as_tensor(v, dtype=torch.float64).to(device, dtype)
              for k, v in arrays.items()}
    return Grid(nx=nx, ny=ny, nz=nz, ptop=cfg.ptop, dy=round_to(dy, dtype),
                dt=round_to(dt, dtype), **arrays)
