"""Gray-atmosphere column radiation: shortwave + longwave.

Port of ``climate_model_tpu/physics/radiation.py``: Beer-Lambert shortwave
with surface-albedo reflection and multi-layer emissivity longwave, column
by column with vertical sweeps only. Radiation runs every
``rad_every_steps`` steps and its outputs (``dpottdt_rad`` and the surface
SW/LW fluxes) are cached in the State; the interval is a host-side ``if`` on
the step counter. The absorption coefficients and their tuning notes are the
reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import constants as c
from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore import operators as ops

K_SW_QV = 0.0005     # shortwave absorption by water vapor [m2 kg-1]
K_SW_DRY = 5.0e-6    # shortwave background (ozone/aerosol stand-in)
K_LW_QV = 0.004      # longwave absorption by water vapor
K_LW_DRY = 1.0e-4    # longwave background (CO2 stand-in)
K_LW_QC = 0.15       # longwave absorption by cloud water
DAY0 = 80.0          # simulations start at the March equinox (day-of-year 80)


class RadiationOut(NamedTuple):
    dpottdt_rad: torch.Tensor   # (nz, ny, nx) [K s-1] heating of POTT
    swflx_sfc: torch.Tensor     # (ny, nx) [W m-2] SW absorbed by surface
    lwflx_sfc: torch.Tensor     # (ny, nx) [W m-2] net LW into surface
    swflx_toa: torch.Tensor     # (ny, nx) [W m-2] net SW absorbed column+sfc
    olr: torch.Tensor           # (ny, nx) [W m-2] outgoing longwave at TOA


def solar_zenith_cos(t, lat, lon):
    """cos(solar zenith angle) from sim time [s] and lat/lon [rad]:
    declination from day of year, hour angle from longitude + time of day;
    clipped at the horizon."""
    doy = DAY0 + t / c.SECONDS_PER_DAY
    decl = math.radians(23.44) * torch.sin(2.0 * math.pi * (doy - 80.0) / 365.25)
    hour_angle = 2.0 * math.pi * torch.remainder(t / c.SECONDS_PER_DAY, 1.0) \
        + lon - math.pi
    mu = torch.sin(lat) * torch.sin(decl) \
        + torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle)
    return torch.clamp(mu, min=0.0)


def gray_radiation_core(kax: int, nz: int, mass, dp, tair, qv, qc, b_sfc,
                        albedo, toa_dn, inv_mu):
    """Gray-gas SW + LW column radiation, generic over the level axis
    ``kax``. k-extent tensors carry nz levels on ``kax``; per-column tensors
    (``b_sfc``, ``albedo``, ``toa_dn``, ``inv_mu``) a singleton there.
    Returns ``(heat, swflx_sfc, lwflx_sfc, f_up_toa, olr)``; ``heat`` is the
    layer heating dT/dt [K s-1] (divide by PVTF for dPOTTdt).

    The LW sweeps (affine recurrences F' = a*F + c) and the SW cumulative
    transmissions are SEQUENTIAL sweeps over the level axis, one exact
    evaluation order on every device: the reference's log-depth scans were
    numerically wrong on its TPU at production shapes (docs/STATUS.md,
    round-4 postmortem), and the sequential form is the one it kept."""
    cat = lambda xs: torch.cat(xs, dim=kax)
    sl = lambda x, lo, hi: x.narrow(kax, lo, hi - lo)

    def seq(f, init, xs, reverse=False):
        """Sequential first-order sweep over the level axis; returns the
        carries stacked along ``kax`` (length nz)."""
        order = range(nz - 1, -1, -1) if reverse else range(nz)
        carry = init
        ys = [None] * nz
        for k in order:
            carry = f(carry, tuple(sl(x, k, k + 1) for x in xs))
            ys[k] = carry
        return cat(ys)

    # ---- shortwave: Beer-Lambert down-beam, albedo-reflected up-beam ----
    tau_sw = (K_SW_QV * qv + K_SW_DRY) * mass
    trans_dn = torch.exp(-tau_sw * inv_mu)
    cumtrans = seq(lambda cc, x: cc * x[0],
                   torch.ones_like(sl(trans_dn, 0, 1)), (trans_dn,))
    ones = torch.ones_like(sl(cumtrans, 0, 1))
    f_dn = toa_dn * cat([ones, cumtrans])                   # borders 0..nz
    sw_sfc_dn = sl(f_dn, nz, nz + 1)
    swflx_sfc = (1.0 - albedo) * sw_sfc_dn
    trans_up = torch.exp(-tau_sw * 1.66)
    refl = albedo * sw_sfc_dn
    cumtrans_up = seq(lambda cc, x: cc * x[0],
                      torch.ones_like(sl(trans_up, 0, 1)), (trans_up,),
                      reverse=True)
    f_up = refl * cat([cumtrans_up, ones])
    abs_sw = (sl(f_dn, 0, nz) - sl(f_dn, 1, nz + 1)) \
        + (sl(f_up, 1, nz + 1) - sl(f_up, 0, nz))
    dtdt_sw = abs_sw * c.G / (c.C_P * dp)

    # ---- longwave (emissivity exchange, diffuse path factor 1.66) ----
    eps = 1.0 - torch.exp(-1.66 * (K_LW_QV * qv + K_LW_DRY + K_LW_QC * qc)
                          * mass)
    b = c.SIGMA_SB * tair ** 4
    a, e_b = 1.0 - eps, eps * b

    # downward sweep: D[0] = 0; D[k+1] = D[k]*(1-eps_k) + eps_k*B_k
    c_dn = seq(lambda d, x: d * x[0] + x[1],
               torch.zeros_like(sl(a, 0, 1)), (a, e_b))
    zeros = torch.zeros_like(sl(c_dn, 0, 1))
    f_dn_lw = cat([zeros, c_dn])
    # upward sweep from the surface: U[nz] = B_sfc; U[k] = U[k+1]*a_k + e_b_k
    u_up = seq(lambda uu, x: uu * x[0] + x[1],
               b_sfc * torch.ones_like(sl(a, 0, 1)), (a, e_b), reverse=True)
    f_up_lw = cat([u_up, b_sfc])

    net_up = f_up_lw - f_dn_lw
    dtdt_lw = (sl(net_up, 1, nz + 1) - sl(net_up, 0, nz)) \
        * c.G / (c.C_P * dp)

    lwflx_sfc = sl(f_dn_lw, nz, nz + 1) - b_sfc
    return (dtdt_sw + dtdt_lw, swflx_sfc, lwflx_sfc, sl(f_up, 0, 1),
            sl(net_up, 0, 1))


def effective_albedo(tsurf, albedo_map, cfg: ModelConfig):
    """Surface SW albedo: the static map, raised to the ice/snow value where
    the surface is frozen."""
    p = cfg.physics
    if not p.dynamic_albedo:
        return albedo_map
    return torch.where(tsurf < c.T_ZERO_C,
                       torch.full_like(albedo_map, p.albedo_ice), albedo_map)


def solar_forcing(t, lat, lon, tsurf, albedo_map, cfg: ModelConfig):
    """``(toa_dn, inv_mu, albedo)`` for the SW calculation; inv_mu is the
    slant-path amplification 1/mu, capped for grazing sun."""
    mu = solar_zenith_cos(t, lat, lon)
    toa_dn = cfg.physics.solar_constant * mu
    inv_mu = 1.0 / torch.clamp(mu, min=0.05)
    return toa_dn, inv_mu, effective_albedo(tsurf, albedo_map, cfg)


def compute_radiation(state: State, grid: Grid, forcing: Forcing,
                      cfg: ModelConfig) -> RadiationOut:
    """One full radiation calculation (standard layout, k on axis 0)."""
    colp, pott, qv, qc = state.colp, state.pott, state.qv, state.qc
    _, pvtf, _ = ops.diagnose_pressure(colp, grid)
    tair = pott * pvtf
    dp = colp[None] * grid.dsigma[:, None, None]
    mass = dp / c.G

    lat2 = grid.lat[:, None]
    lon2 = grid.lon[None, :]
    toa_dn, inv_mu, albedo = solar_forcing(state.t, lat2, lon2, state.tsurf,
                                           forcing.albedo, cfg)
    b_sfc = c.SIGMA_SB * state.tsurf ** 4

    heat, swflx_sfc, lwflx_sfc, f_up_toa, olr = gray_radiation_core(
        0, grid.nz, mass, dp, tair, qv, qc, b_sfc[None], albedo[None],
        toa_dn[None], inv_mu[None])
    return RadiationOut(dpottdt_rad=heat / pvtf, swflx_sfc=swflx_sfc[0],
                        lwflx_sfc=lwflx_sfc[0],
                        swflx_toa=toa_dn - f_up_toa[0], olr=olr[0])


def radiation_step(state: State, grid: Grid, forcing: Forcing,
                   cfg: ModelConfig) -> State:
    """Recompute the radiation cache when step % rad_every_steps == 0 (a
    host-side test of the host step counter). ``radiation_step.refreshes``
    counts the recomputations, so a run can show its cadence."""
    every = max(cfg.physics.rad_every_steps, 1)
    if state.step % every != 0:
        return state
    radiation_step.refreshes += 1
    out = compute_radiation(state, grid, forcing, cfg)
    return state.replace(dpottdt_rad=out.dpottdt_rad,
                         swflx_sfc=out.swflx_sfc, lwflx_sfc=out.lwflx_sfc)


radiation_step.refreshes = 0
