"""Frozen copy of ``climate_model_tpu_torch/core/state.py`` at commit dbbffa0
(the benchmark's plain reference; imports nothing of the port).

Model state and forcing: dataclasses of tensors.

Port of ``climate_model_tpu/core/state.py``. 3-D fields are ``(nz, ny, nx)``,
2-D fields ``(ny, nx)``, all contiguous at the working dtype on one device.
Two departures from the reference's pytree: the sim time ``t`` is a 0-d
tensor on the device (it accumulates ``t + dt`` in the working dtype, as the
reference does), and the step counter ``step`` is a host int, so the
radiation interval is a host-side ``if`` that never reads the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class State:
    """Prognostic model state (+ slow-physics caches)."""

    u: torch.Tensor       # zonal wind at west faces [m s-1]
    v: torch.Tensor       # meridional wind at south faces [m s-1]; v[:,0,:] = 0
    colp: torch.Tensor    # column pressure p_surf - p_top [Pa]
    pott: torch.Tensor    # potential temperature [K]
    qv: torch.Tensor      # water-vapor mixing ratio [kg kg-1]
    qc: torch.Tensor      # cloud-water mixing ratio [kg kg-1]
    tsurf: torch.Tensor   # surface/soil temperature [K], (ny, nx)
    rain: torch.Tensor    # accumulated surface precipitation [kg m-2]
    soil_moist: torch.Tensor  # prognostic soil water [m], (ny, nx)
    dpottdt_rad: torch.Tensor  # cached radiative heating of POTT [K s-1]
    swflx_sfc: torch.Tensor    # cached net SW absorbed at surface [W m-2]
    lwflx_sfc: torch.Tensor    # cached net LW at surface (down-up) [W m-2]
    t: torch.Tensor            # sim time [s], 0-d tensor
    step: int                  # step counter (host)

    @property
    def dtype(self):
        return self.u.dtype

    @property
    def device(self):
        return self.u.device

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Forcing:
    """Static surface/boundary fields, (ny, nx)."""

    hsurf: torch.Tensor       # surface elevation [m]
    land_mask: torch.Tensor   # 1.0 = land, 0.0 = ocean
    albedo: torch.Tensor      # surface albedo
    evap_eff: torch.Tensor    # surface evaporation efficiency 0..1


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` is the default of every
    entry point; asking for it without a card raises (there is no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return dev
