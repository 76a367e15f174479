"""Frozen copy of ``climate_model_tpu_torch/core/init.py`` at commit dbbffa0
(the benchmark's plain reference; imports nothing of the port).

Analytic initial conditions + synthetic topography.

Port of ``climate_model_tpu/core/init.py``: lapse-rate POTT profile, COLP
reduced over topography, a zonal jet and a gaussian COLP low, and the
synthetic topographies. Everything is computed in float64 NumPy with the same
expressions as the reference and cast once, so the port starts bit-identical
to the reference at every dtype. ``topo_file`` reads the topography from a
NetCDF elevation file instead (``io/topo.py``).
"""

from __future__ import annotations

import numpy as np
from .thermo import qsat_water
from . import constants as c
from .config import ModelConfig
from .grid import make_grid

T0 = 288.0          # reference surface temperature [K]
THETA_SFC = 285.0   # surface potential temperature [K]
DTHETA = 50.0       # stratification: theta increase top vs surface [K]
RH0 = 0.7           # boundary-layer relative humidity for QV init


def synthetic_topography(grid_np, kind: str = "gaussian_mountain"):
    """Synthetic HSURF + land-sea mask on the model grid (fp64 NumPy)."""
    lat = grid_np.lat[:, None]
    lon = grid_np.lon[None, :]
    ny, nx = lat.shape[0], lon.shape[1]
    if kind == "aquaplanet":
        return np.zeros((ny, nx)), np.zeros((ny, nx))
    if kind == "gaussian_mountain":
        lat_c, lon_c = np.deg2rad(40.0), np.deg2rad(90.0)
        width = np.deg2rad(15.0)
        dlon = np.angle(np.exp(1j * (lon - lon_c)))          # periodic distance
        r2 = ((lat - lat_c) ** 2 + (np.cos(lat_c) * dlon) ** 2) / width ** 2
        hsurf = 2000.0 * np.exp(-r2)
        land = (hsurf > 100.0).astype(np.float64)
        return hsurf, land
    if kind == "continents":
        return continents_topography(grid_np)
    raise ValueError(f"unknown topography kind {kind!r}")


def continents_topography(grid_np):
    """Procedural Earth-like continental configuration (round 5).

    The reference bundles real ETOPO-style NetCDF inputs (SURVEY.md §2.3
    [P]); this box has no network access, so this is the documented
    reachable approximation (VERDICT r4 missing #4): idealized landmasses
    at Earth-like positions, a land fraction near Earth's ~0.29
    (area-weighted, within the 80S-80N domain), mid-latitude cordilleras
    and a Tibet-like plateau so the stationary-wave and monsoon forcings
    the reference's real topography provides have analogues. Fully
    deterministic fp64 NumPy, so the port and the reference start
    bit-identical.

    Construction: each landmass is a smooth super-gaussian "potential"
    blob in (lat, lon); land is potential > 0.5, interior elevation rises
    with the potential (coasts near sea level), and ridge features add
    localized mountain belts on top.
    """
    latd = np.rad2deg(grid_np.lat)[:, None]
    lond = np.rad2deg(grid_np.lon)[None, :]

    def blob(lat_c, lon_c, lat_w, lon_w, p=3.0):
        dlon = (lond - lon_c + 180.0) % 360.0 - 180.0       # periodic
        r = ((latd - lat_c) / lat_w) ** 2 + (dlon / lon_w) ** 2
        return np.exp(-np.log(2.0) * r ** p)                # 0.5 at r=1

    def ridge(lat0, lon0, lat1, lon1, width_deg, height):
        # mountain belt along the segment (lat0,lon0)-(lat1,lon1)
        t = np.linspace(0.0, 1.0, 48)[:, None, None]
        lc = lat0 + (lat1 - lat0) * t
        oc = lon0 + (lon1 - lon0) * t
        dlon = (lond[None] - oc + 180.0) % 360.0 - 180.0
        d2 = (latd[None] - lc) ** 2 + (np.cos(np.deg2rad(lc)) * dlon) ** 2
        return height * np.max(np.exp(-d2 / width_deg ** 2), axis=0)

    # landmasses: (lat_c, lon_c, lat_halfwidth, lon_halfwidth) in degrees
    pot = np.zeros_like(latd * lond)
    for b in [
        (50.0, 250.0, 23.0, 38.0),     # North-America-like
        (-18.0, 300.0, 29.0, 17.0),    # South-America-like
        (12.0, 22.0, 34.0, 24.0),      # Africa-like
        (52.0, 45.0, 17.0, 30.0),      # Europe-like
        (42.0, 95.0, 24.0, 46.0),      # Asia-like
        (-25.0, 133.0, 15.0, 19.0),    # Australia-like
        (-75.0, 180.0, 14.0, 180.0),   # Antarctic fringe (inside 80S wall)
    ]:
        pot = pot + blob(*b)
    land = (pot > 0.5).astype(np.float64)

    # interior elevation: coasts at ~0, interiors ~700 m (Earth's mean land
    # elevation ~800 m), plus mountain belts
    interior = np.clip((pot - 0.5) / 0.5, 0.0, 1.0)
    hsurf = 700.0 * interior
    hsurf = hsurf + ridge(60.0, 228.0, 35.0, 245.0, 6.0, 2300.0)   # Rockies
    hsurf = hsurf + ridge(8.0, 282.0, -50.0, 289.0, 4.0, 3500.0)   # Andes
    hsurf = hsurf + ridge(33.0, 78.0, 38.0, 100.0, 9.0, 4300.0)    # Tibet
    hsurf = hsurf + ridge(44.0, 7.0, 46.0, 16.0, 4.0, 1800.0)      # Alps
    hsurf = hsurf * land                                           # ocean = 0
    return hsurf, land


def initial_state_np(cfg: ModelConfig, kind: str = None,
                     u_jet: float = 10.0, colp_pert: float = -500.0,
                     topo_file: str = None):
    """Build the IC in fp64 NumPy. Returns (state dict, forcing dict,
    grid_np). The jet and a gaussian COLP low excite dynamics (reference's
    ``gaussian perturbation in UWIND or COLP`` [P]). ``kind``/``topo_file``
    default from ``cfg.topo``/``cfg.topo_file`` (the configured topography
    is part of the checkpoint identity); explicit arguments override for
    ad-hoc experiments. ``topo_file`` (a NetCDF elevation file, reference
    ETOPO-input parity) overrides the synthetic ``kind``."""
    kind = kind or cfg.topo
    topo_file = topo_file or cfg.topo_file
    gc = cfg.grid
    grid_np = make_grid(gc, cfg.numerics, np_mode=True)
    nz, ny, nx = gc.nz, gc.ny, gc.nx
    lat = grid_np.lat[:, None]
    lon = grid_np.lon[None, :]

    p = cfg.physics
    if topo_file:
        raise ValueError("the reference builds synthetic topographies only")
    hsurf, land = synthetic_topography(grid_np, kind)
    albedo = np.where(land > 0.5, p.albedo_land, p.albedo_ocean)
    evap_eff = np.where(land > 0.5, p.evap_efficiency_land, 1.0)

    # COLP reduced hydrostatically over topography.
    psurf = gc.psurf * np.exp(-c.G * hsurf / (c.R_D * T0))
    colp = psurf - gc.ptop

    # Gaussian low-pressure perturbation (excites gravity/Rossby waves).
    lat_c, lon_c = np.deg2rad(-30.0), np.deg2rad(210.0)
    width = np.deg2rad(12.0)
    dlon = np.angle(np.exp(1j * (lon - lon_c)))
    r2 = ((lat - lat_c) ** 2 + (np.cos(lat_c) * dlon) ** 2) / width ** 2
    colp = colp + colp_pert * np.exp(-r2)

    # Stable stratification theta(sigma).
    sig = grid_np.sigma[:, None, None]
    pott = (THETA_SFC + DTHETA * (1.0 - sig)) * np.ones((nz, ny, nx))

    # Zonal jet at u points (same latitude rows as centers); vanishes at walls.
    latu = grid_np.lat[None, :, None]
    lat0 = grid_np.lats[0]
    lat1 = 2.0 * grid_np.lat[-1] - grid_np.lats[-1]   # north wall
    ujet_shape = np.sin(np.pi * (latu - lat0) / (lat1 - lat0)) ** 2
    u = u_jet * ujet_shape * (1.0 - sig) * np.ones((nz, ny, nx))
    v = np.zeros((nz, ny, nx))

    # Moisture: RH0 at the surface layers falling off with sigma^2.
    pair = grid_np.ptop + sig * colp[None]
    tair = pott * (pair / c.P_REF) ** c.KAPPA
    qv = RH0 * (grid_np.sigma[:, None, None] ** 2) * qsat_water(tair, pair, np)
    qc = np.zeros((nz, ny, nx))

    # Surface starts 1 K warmer than the lowest-layer air (weakly unstable,
    # so surface fluxes engage immediately); the meridional structure comes
    # from radiation + the surface energy budget during the run.
    tsurf = tair[-1] + 1.0
    # Soil water: land starts half-full (reference soil moisture IC [P]);
    # ocean cells carry field capacity so their evap efficiency is 1.
    soil_moist = np.where(land > 0.5, p.soil_moist_init, p.soil_moist_cap)
    state = dict(u=u, v=v, colp=colp, pott=pott, qv=qv, qc=qc,
                 tsurf=tsurf, rain=np.zeros((ny, nx)), soil_moist=soil_moist)
    forcing = dict(hsurf=hsurf, land_mask=land, albedo=albedo,
                   evap_eff=evap_eff)
    return state, forcing, grid_np
