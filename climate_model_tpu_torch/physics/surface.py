"""Surface/soil model: slab land + slab ocean, bulk turbulent fluxes.

Port of ``climate_model_tpu/physics/surface.py``: prognostic surface
temperature from net radiative + turbulent fluxes, the soil-water bucket,
and the surface sensible/latent/momentum fluxes deposited into the lowest
model layer (operator split, elementwise over (ny, nx)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import constants as c
from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore import boundaries as bc
from ..dycore import operators as ops


class SurfaceFluxes(NamedTuple):
    shflx: torch.Tensor   # sensible heat flux into atmosphere [W m-2]
    lhflx: torch.Tensor   # latent heat flux into atmosphere [W m-2]
    evap: torch.Tensor    # surface evaporation [kg m-2 s-1]
    taux: torch.Tensor    # zonal surface stress on lowest layer [N m-2]
    tauy: torch.Tensor    # meridional surface stress [N m-2]


def evap_efficiency(state: State, forcing: Forcing, cfg: ModelConfig):
    """Evaporation efficiency 0..1: with soil hydrology on, land follows the
    soil water fraction of field capacity and ocean evaporates freely;
    otherwise the static Forcing.evap_eff map."""
    p = cfg.physics
    if not (p.surface and p.soil_moisture):
        return forcing.evap_eff
    frac = torch.clamp(state.soil_moist / p.soil_moist_cap, 0.0, 1.0)
    return torch.where(forcing.land_mask > 0.5, frac, torch.ones_like(frac))


def surface_fluxes(state: State, grid: Grid, forcing: Forcing,
                   cfg: ModelConfig, press=None) -> SurfaceFluxes:
    from .thermo import qsat_water

    p = cfg.physics
    pvb, pvtf, _ = press if press is not None \
        else ops.diagnose_pressure(state.colp, grid)
    t_air = state.pott[-1] * pvtf[-1]
    p_air = 0.5 * (pvb[-2] + pvb[-1])
    rho = p_air / (c.R_D * t_air)

    # wind at cell centers (lowest layer); 1 m/s gustiness floor
    u_c = 0.5 * (state.u[-1] + bc.east(state.u[-1]))
    v_c = 0.5 * (state.v[-1] + bc.north_zero(state.v[-1]))
    wind = torch.sqrt(u_c ** 2 + v_c ** 2 + 1.0)

    ch = p.drag_coef
    shflx = rho * c.C_P * ch * wind * (state.tsurf - t_air)
    qsat_s = qsat_water(state.tsurf, pvb[-1])
    evap = rho * ch * wind * evap_efficiency(state, forcing, cfg) \
        * torch.clamp(qsat_s - state.qv[-1], min=0.0)
    lhflx = c.L_V * evap
    taux = -rho * ch * wind * u_c
    tauy = -rho * ch * wind * v_c
    return SurfaceFluxes(shflx=shflx, lhflx=lhflx, evap=evap,
                         taux=taux, tauy=tauy)


def _add_bottom(x, d):
    """``x`` with ``d`` added to its lowest layer (a new tensor)."""
    return torch.cat([x[:-1], (x[-1] + d)[None]], dim=0)


def surface_step(state: State, grid: Grid, forcing: Forcing,
                 cfg: ModelConfig, dt, press=None) -> State:
    """Advance TSURF (slab land/ocean energy budget) and apply the surface
    fluxes to the lowest model layer."""
    p = cfg.physics
    if press is None:
        press = ops.diagnose_pressure(state.colp, grid)
    fx = surface_fluxes(state, grid, forcing, cfg, press=press)
    _, pvtf_, _ = press

    heat_cap = torch.where(forcing.land_mask > 0.5,
                           torch.full_like(state.tsurf, p.soil_heat_capacity),
                           torch.full_like(state.tsurf, p.ocean_heat_capacity))
    net = state.swflx_sfc + state.lwflx_sfc - fx.shflx - fx.lhflx
    tsurf = state.tsurf + dt * net / heat_cap

    # deposit fluxes into the lowest layer (mass colp*dsigma/g per m^2)
    dp_sfc = state.colp * grid.dsigma[-1]
    m_sfc = dp_sfc / c.G
    dpott = dt * fx.shflx / (c.C_P * m_sfc) / pvtf_[-1]
    dqv = dt * fx.evap / m_sfc
    pott = _add_bottom(state.pott, dpott)
    qv = _add_bottom(state.qv, dqv)

    # momentum drag at u/v points (stress averaged to faces)
    m_u = 0.5 * (bc.west(dp_sfc) + dp_sfc) / c.G
    m_v = 0.5 * (bc.south_clamp(dp_sfc) + dp_sfc) / c.G
    du = dt * 0.5 * (bc.west(fx.taux) + fx.taux) / m_u
    dv = dt * 0.5 * (bc.south_clamp(fx.tauy) + fx.tauy) / m_v
    u = _add_bottom(state.u, du)
    v = bc.enforce_v_walls(_add_bottom(state.v, dv))

    # soil hydrology: evaporation dries the land bucket
    soil_moist = state.soil_moist
    if p.soil_moisture:
        dried = torch.clamp(soil_moist - dt * fx.evap / c.RHO_WATER,
                            0.0, p.soil_moist_cap)
        soil_moist = torch.where(forcing.land_mask > 0.5, dried, soil_moist)
    return state.replace(tsurf=tsurf, pott=pott, qv=qv, u=u, v=v,
                         soil_moist=soil_moist)
