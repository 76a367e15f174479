"""Real-topography input: NetCDF elevation -> model-grid HSURF + land mask.

A copy of ``climate_model_tpu/io/topo.py`` (NumPy only), so that the port
never imports the JAX package: an ETOPO-like elevation file coarsened to the
model grid; the synthetic topography of ``core/init.py`` stays the default.

Input convention: a NetCDF file with 1-D ``lat``/``lon`` coordinate
variables (degrees) and a 2-D elevation variable (m, negative = ocean
bathymetry). Regridding is area-style box averaging over source cells that
fall inside each model cell (falls back to nearest neighbor when the source
is coarser than the model grid).
"""

from __future__ import annotations

import numpy as np


def load_topography(path: str, grid_np, elevation_var: str = "z",
                    land_threshold: float = 0.0):
    """Return (hsurf, land_mask) on the model grid (fp64 NumPy).

    ``grid_np`` is a NumPy-mode Grid (``core/grid.py::make_grid(...,
    np_mode=True)``).
    """
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        src_lat = np.asarray(f.variables["lat"][:], np.float64)
        src_lon = np.asarray(f.variables["lon"][:], np.float64) % 360.0
        z = np.asarray(f.variables[elevation_var][:], np.float64)

    order_lat = np.argsort(src_lat)
    order_lon = np.argsort(src_lon)
    src_lat, src_lon = src_lat[order_lat], src_lon[order_lon]
    z = z[np.ix_(order_lat, order_lon)]

    lat_deg = np.rad2deg(grid_np.lat)
    lon_deg = np.rad2deg(grid_np.lon) % 360.0
    dlat = lat_deg[1] - lat_deg[0] if len(lat_deg) > 1 else 180.0
    dlon = (np.rad2deg(grid_np.lon[1] - grid_np.lon[0])
            if len(lon_deg) > 1 else 360.0)

    ny, nx = len(lat_deg), len(lon_deg)
    hsurf = np.empty((ny, nx))
    land = np.empty((ny, nx))
    # index bins of source points per model cell
    lat_edges = np.concatenate([lat_deg - dlat / 2, [lat_deg[-1] + dlat / 2]])
    lat_idx = np.searchsorted(src_lat, lat_edges)
    lon_edges = (np.concatenate([lon_deg - dlon / 2,
                                 [lon_deg[-1] + dlon / 2]])) % 360.0

    for j in range(ny):
        j0, j1 = lat_idx[j], max(lat_idx[j + 1], lat_idx[j] + 1)
        j0 = min(j0, len(src_lat) - 1)
        band = z[j0:j1]
        for i in range(nx):
            lo, hi = lon_edges[i], (lon_edges[i] + dlon) % 360.0
            if lo < hi:
                sel = (src_lon >= lo) & (src_lon < hi)
            else:                      # wrap across the 360 seam
                sel = (src_lon >= lo) | (src_lon < hi)
            if not sel.any():          # source coarser than model: nearest
                sel = np.array([np.argmin(np.minimum(
                    np.abs(src_lon - lon_deg[i]),
                    360.0 - np.abs(src_lon - lon_deg[i])))])
            cell = band[:, sel]
            hsurf[j, i] = cell.mean()
            land[j, i] = float((cell > land_threshold).mean() > 0.5)

    # the model's HSURF is surface elevation (>= 0); ocean cells sit at 0
    hsurf = np.where(land > 0.5, np.maximum(hsurf, 0.0), 0.0)
    return hsurf, land
