"""Turbulent vertical diffusion (K-closure).

Port of ``climate_model_tpu/physics/turbulence.py``: column-local flux-form
diffusion in height coordinates reconstructed from the hydrostatic
geopotential, explicit in time, with the optional moist-convective mixing
guard (``convective_k``).
"""

from __future__ import annotations

import torch

from ..core import constants as c
from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore import boundaries as bc
from ..dycore import operators as ops


def convective_k(state: State, pvb, pvtf, cfg: ModelConfig):
    """ADDITIVE diffusivity at the nz-1 interior interfaces where a column is
    near-saturated AND moist-unstable (saturation equivalent potential
    temperature decreasing with height)."""
    from .thermo import qsat_water

    p = cfg.physics
    tair = state.pott * pvtf
    pair = 0.5 * (pvb[:-1] + pvb[1:])
    qs = qsat_water(tair, pair)
    rh = state.qv / torch.clamp(qs, min=1e-10)
    theta_es = state.pott * torch.exp(c.L_V * qs / (c.C_P * tair))
    near_sat = torch.minimum(rh[:-1], rh[1:]) > p.conv_rh_crit
    unstable = theta_es[:-1] < theta_es[1:]          # axis 0: k=0 is top
    k = torch.zeros_like(theta_es[:-1])
    return torch.where(near_sat & unstable,
                       torch.full_like(k, p.conv_diffusivity), k)


def turbulence_step(state: State, grid: Grid, forcing: Forcing,
                    cfg: ModelConfig, dt, press=None) -> State:
    p = cfg.physics
    pvb, pvtf, pvtfvb = press if press is not None \
        else ops.diagnose_pressure(state.colp, grid)
    phi, phivb = ops.diagnose_geopotential(state.pott, pvtf, pvtfvb,
                                           forcing.hsurf)
    tair = state.pott * pvtf
    z_c = phi / c.G
    z_vb = phivb / c.G
    dz_c = z_vb[:-1] - z_vb[1:]                  # layer thickness (>0)
    dz_vb = z_c[:-1] - z_c[1:]                   # center-to-center (>0)

    pair_vb = pvb[1:-1]
    tair_vb = 0.5 * (tair[:-1] + tair[1:])
    rho_vb = pair_vb / (c.R_D * tair_vb)
    rho_c = (pvb[1:] - pvb[:-1]) / (c.G * dz_c)

    def diffuse(x, k_coef, dzc, dzvb, rvb, rc):
        # upward-positive diffusive flux at interior borders, zero at the
        # top and bottom (the surface flux is the surface model's)
        grad = (x[:-1] - x[1:]) / dzvb
        flux = -k_coef * rvb * grad
        zero = torch.zeros_like(flux[:1])
        flux = torch.cat([zero, flux, zero], dim=0)
        return x + dt * (flux[1:] - flux[:-1]) / (rc * dzc)

    k_scalar = p.diff_coef_scalar
    if p.convection:
        k_scalar = k_scalar + convective_k(state, pvb, pvtf, cfg)
    pott = diffuse(state.pott, k_scalar, dz_c, dz_vb, rho_vb, rho_c)
    qv = diffuse(state.qv, k_scalar, dz_c, dz_vb, rho_vb, rho_c)
    qc = diffuse(state.qc, k_scalar, dz_c, dz_vb, rho_vb, rho_c)

    dz_c_u = 0.5 * (bc.west(dz_c) + dz_c)
    dz_vb_u = 0.5 * (bc.west(dz_vb) + dz_vb)
    rvb_u = 0.5 * (bc.west(rho_vb) + rho_vb)
    rc_u = 0.5 * (bc.west(rho_c) + rho_c)
    u = diffuse(state.u, p.diff_coef_momentum, dz_c_u, dz_vb_u, rvb_u, rc_u)

    dz_c_v = 0.5 * (bc.south_clamp(dz_c) + dz_c)
    dz_vb_v = 0.5 * (bc.south_clamp(dz_vb) + dz_vb)
    rvb_v = 0.5 * (bc.south_clamp(rho_vb) + rho_vb)
    rc_v = 0.5 * (bc.south_clamp(rho_c) + rho_c)
    v = bc.enforce_v_walls(
        diffuse(state.v, p.diff_coef_momentum, dz_c_v, dz_vb_v, rvb_v, rc_v))

    return state.replace(u=u, v=v, pott=pott, qv=torch.clamp(qv, min=0.0),
                         qc=torch.clamp(qc, min=0.0))
