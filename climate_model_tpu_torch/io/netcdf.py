"""NetCDF output.

Port of ``climate_model_tpu/io/netcdf.py``: ``out_NNNN.nc`` snapshots with
dims (time, level, lat, lon) and the reference's variables and attributes,
plus a ``constants.nc`` with the grid, HSURF, the land mask and the albedo;
NetCDF-3 classic through ``scipy.io.netcdf_file``. TAIR and PHI
(``dycore/operators.py::diagnose``) and WWIND (``continuity``) are computed
on the state's device at its dtype; every field is cast to fp32 there and
copied to the host in one transfer.

The writer is host-local. A sharded run passes its gathered global state,
and only rank 0 of a ``torch.distributed`` run writes (the others keep the
sequence count), in place of the reference's ``host_global``.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch
import torch.distributed as tdist
# at import, not in the first write: a run imports this module before its
# timed loop, whose first output chunk would otherwise carry scipy's import
from scipy.io import netcdf_file

from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore import operators as ops


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _fp32_on_host(fields: dict) -> dict:
    """``fields`` cast to fp32 on their device and fetched in one copy."""
    flat = torch.cat([x.reshape(-1).to(torch.float32)
                      for x in fields.values()]).cpu().numpy()
    out, o = {}, 0
    for name, x in fields.items():
        out[name] = flat[o:o + x.numel()].reshape(x.shape)
        o += x.numel()
    return out


def write_constants_nc(path: str, grid: Grid, forcing: Forcing):
    """Constants file: grid coordinates, HSURF, land mask, albedo."""
    with netcdf_file(path, "w") as f:
        ny, nx = forcing.hsurf.shape
        f.createDimension("lat", ny)
        f.createDimension("lon", nx)
        f.createDimension("level", grid.nz)
        f.createDimension("levels", grid.nz + 1)
        for name, dims, data in (
            ("lat", ("lat",), np.rad2deg(_host(grid.lat))),
            ("lon", ("lon",), np.rad2deg(_host(grid.lon))),
            ("sigma", ("level",), _host(grid.sigma)),
            ("sigma_vb", ("levels",), _host(grid.sigma_vb)),
            ("HSURF", ("lat", "lon"), _host(forcing.hsurf)),
            ("LAND_MASK", ("lat", "lon"), _host(forcing.land_mask)),
            ("ALBEDO", ("lat", "lon"), _host(forcing.albedo)),
        ):
            v = f.createVariable(name, "f", dims)
            v[:] = np.asarray(data, np.float32)


def write_output_nc(path: str, state: State, grid: Grid, forcing: Forcing):
    """One output snapshot."""
    diag = ops.diagnose(state.colp, state.pott, forcing.hsurf, grid)
    cont = ops.continuity(state.u, state.v, state.colp, state.colp,
                          grid.dt, grid)
    names3 = ("UWIND", "VWIND", "POTT", "TAIR", "PHI", "QV", "QC")
    names2 = ("PSURF", "COLP", "RAIN", "TSURF", "SOILMOIST")
    host = _fp32_on_host(dict(
        UWIND=state.u, VWIND=state.v, POTT=state.pott, TAIR=diag.tair,
        PHI=diag.phi, QV=state.qv, QC=state.qc, WWIND=cont.wwind,
        PSURF=grid.ptop + state.colp, COLP=state.colp, RAIN=state.rain,
        TSURF=state.tsurf, SOILMOIST=state.soil_moist))
    with netcdf_file(path, "w") as f:
        nz, ny, nx = state.u.shape
        f.createDimension("time", 1)
        f.createDimension("level", nz)
        f.createDimension("levels", nz + 1)
        f.createDimension("lat", ny)
        f.createDimension("lon", nx)
        tv = f.createVariable("time", "f", ("time",))
        tv[:] = np.asarray([float(state.t) / 86400.0], np.float32)
        tv.units = b"days since start"
        for name, vals in (("lat", np.rad2deg(_host(grid.lat))),
                           ("lon", np.rad2deg(_host(grid.lon)))):
            cv = f.createVariable(name, "f", (name,))
            cv[:] = np.asarray(vals, np.float32)
            cv.units = b"degrees"
        for name in names3:
            v = f.createVariable(name, "f", ("time", "level", "lat", "lon"))
            v[:] = host[name][None]
        wv = f.createVariable("WWIND", "f", ("time", "levels", "lat", "lon"))
        wv[:] = host["WWIND"][None]
        for name in names2:
            v = f.createVariable(name, "f", ("time", "lat", "lon"))
            v[:] = host[name][None]


class NCWriter:
    """Sequenced output files ``out_0000.nc``, ``out_0001.nc``, ... plus a
    one-time ``constants.nc``; a resume continues the sequence."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        existing = [int(m.group(1))
                    for f in glob.glob(os.path.join(out_dir, "out_*.nc"))
                    if (m := re.search(r"out_(\d+)\.nc$", f))]
        self.count = max(existing) + 1 if existing else 0

    def write(self, state: State, grid: Grid, forcing: Forcing):
        """Write the next file from a global ``state``; None on the ranks
        other than 0."""
        if tdist.is_initialized() and tdist.get_rank() != 0:
            self.count += 1
            return None
        if self.count == 0:
            write_constants_nc(os.path.join(self.out_dir, "constants.nc"),
                               grid, forcing)
        path = os.path.join(self.out_dir, f"out_{self.count:04d}.nc")
        write_output_nc(path, state, grid, forcing)
        self.count += 1
        return path
