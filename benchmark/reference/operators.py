"""Frozen copy of ``climate_model_tpu_torch/dycore/operators.py`` at commit dbbffa0
(the benchmark's plain reference; imports nothing of the port).

Dycore equation operators (plain PyTorch forms).

Port of ``climate_model_tpu/dycore/operators.py``: pressure/Exner/
geopotential diagnostics, continuity, flux-form scalar advection, horizontal
diffusion and momentum tendencies, as shape-polymorphic pure functions of
``(nz, ny, nx)`` / ``(ny, nx)`` tensors that broadcast the 1-D per-latitude
geometry. The discrete equations are those of ``docs/NUMERICS.md``; these
forms are the plain version the substep kernel (``kernels/fused_substep.py``)
is held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as c
from .grid import Grid
from . import boundaries as bc


class Diagnostics(NamedTuple):
    pvb: torch.Tensor      # (nz+1, ny, nx) pressure at level borders [Pa]
    pvtf: torch.Tensor     # (nz, ny, nx) layer-mean Exner factor
    pvtfvb: torch.Tensor   # (nz+1, ny, nx) Exner factor at borders
    phi: torch.Tensor      # (nz, ny, nx) geopotential at centers [m2 s-2]
    phivb: torch.Tensor    # (nz+1, ny, nx) geopotential at borders
    tair: torch.Tensor     # (nz, ny, nx) absolute temperature [K]


class Continuity(NamedTuple):
    uflx: torch.Tensor      # (nz, ny, nx) zonal mass flux at u faces
    vflx: torch.Tensor      # (nz, ny, nx) meridional mass flux at v faces
    dcolpdt: torch.Tensor   # (ny, nx) [Pa s-1]
    colp_new: torch.Tensor  # (ny, nx) COLP_base + dt*dcolpdt
    wwind: torch.Tensor     # (nz+1, ny, nx) sigma-velocity at borders [s-1]


class Tendencies(NamedTuple):
    dudt: torch.Tensor      # (nz, ny, nx) d(COLP_u*u)/dt [Pa m s-2]
    dvdt: torch.Tensor
    dcolpdt: torch.Tensor   # (ny, nx)
    dpottdt: torch.Tensor   # (nz, ny, nx) [Pa K s-1]
    dqvdt: torch.Tensor
    dqcdt: torch.Tensor
    colp_new: torch.Tensor  # (ny, nx)
    wwind: torch.Tensor     # (nz+1, ny, nx) diagnostic


def _lat(x):
    """Per-latitude (ny,) geometry broadcast against (nz, ny, nx)."""
    return x[None, :, None]


def _lev(x):
    """Per-level (nz,) geometry broadcast against (nz, ny, nx)."""
    return x[:, None, None]


# ---------------------------------------------------------------------------
# Diagnostics: pressure, Exner factors, temperature, geopotential.
# ---------------------------------------------------------------------------

def diagnose_pressure(colp, grid: Grid):
    """COLP-only part of the diagnostics (Exner factors + border pressures),
    shared across the operator-split physics of one step."""
    pvb = grid.ptop + _lev(grid.sigma_vb) * colp[None]       # (nz+1, ny, nx)
    pvtfvb = (pvb / c.P_REF) ** c.KAPPA
    num = pvb[1:] * pvtfvb[1:] - pvb[:-1] * pvtfvb[:-1]
    pvtf = num / ((1.0 + c.KAPPA) * (pvb[1:] - pvb[:-1]))
    return pvb, pvtf, pvtfvb


def diagnose_geopotential(pott, pvtf, pvtfvb, hsurf):
    """Hydrostatic integration, surface upward, as a suffix sum of the
    per-layer border-to-border jump:
    phivb[k] = g*hsurf + cp * sum_{k'>=k} pott[k']*(pvtfvb[k'+1]-pvtfvb[k'])."""
    jump = c.C_P * pott * (pvtfvb[1:] - pvtfvb[:-1])
    suffix = torch.flip(torch.cumsum(torch.flip(jump, [0]), dim=0), [0])
    phivb_sfc = c.G * hsurf[None]
    phivb = torch.cat([phivb_sfc + suffix, phivb_sfc], dim=0)
    phi = phivb[1:] + c.C_P * pott * (pvtfvb[1:] - pvtf)
    return phi, phivb


def diagnose(colp, pott, hsurf, grid: Grid, press=None) -> Diagnostics:
    if press is None:
        press = diagnose_pressure(colp, grid)
    pvb, pvtf, pvtfvb = press
    tair = pott * pvtf
    phi, phivb = diagnose_geopotential(pott, pvtf, pvtfvb, hsurf)
    return Diagnostics(pvb=pvb, pvtf=pvtf, pvtfvb=pvtfvb, phi=phi,
                       phivb=phivb, tair=tair)


# ---------------------------------------------------------------------------
# Continuity: mass fluxes, dCOLP/dt, sigma vertical velocity.
# ---------------------------------------------------------------------------

def continuity(u, v, colp, colp_base, dt, grid: Grid) -> Continuity:
    colp_u = 0.5 * (bc.west(colp) + colp)
    colp_v = 0.5 * (bc.south_clamp(colp) + colp)

    uflx = u * colp_u[None] * grid.dy
    vflx = bc.enforce_v_walls(v * colp_v[None] * _lat(grid.dxs))

    div = (bc.east(uflx) - uflx + bc.north_zero(vflx) - vflx) \
        / _lat(grid.area)
    dsig = _lev(grid.dsigma)
    dcolpdt = -torch.sum(div * dsig, dim=0)
    colp_new = colp_base + dt * dcolpdt

    csum = torch.cumsum(div * dsig, dim=0)                   # sum_{k'<=k}
    sig_int = _lev(grid.sigma_vb[1:-1])
    w_int = -(csum[:-1] + sig_int * dcolpdt[None]) / colp_new[None]
    zero = torch.zeros_like(w_int[:1])
    wwind = torch.cat([zero, w_int, zero], dim=0)            # (nz+1, ny, nx)
    return Continuity(uflx=uflx, vflx=vflx, dcolpdt=dcolpdt,
                      colp_new=colp_new, wwind=wwind)


# ---------------------------------------------------------------------------
# Scalar flux-form advection (POTT, QV, QC).
# ---------------------------------------------------------------------------

def scalar_tendency(q, cont: Continuity, colp, grid: Grid,
                    source=None, diff_coef=None):
    """d(COLP*q)/dt [Pa q s-1]; ``source`` is a physics source [q s-1]
    (the cached radiative heating for POTT), ``diff_coef`` a per-latitude
    diffusivity or None (off)."""
    fx = cont.uflx * 0.5 * (bc.west(q) + q)
    fy = cont.vflx * 0.5 * (bc.south_clamp(q) + q)
    dqdt = -(bc.east(fx) - fx + bc.north_zero(fy) - fy) / _lat(grid.area)

    q_vb = 0.5 * (q[:-1] + q[1:])
    fz_int = cont.wwind[1:-1] * cont.colp_new[None] * q_vb
    zero = torch.zeros_like(fz_int[:1])
    fz = torch.cat([zero, fz_int, zero], dim=0)
    dqdt = dqdt - (fz[1:] - fz[:-1]) / _lev(grid.dsigma)

    if source is not None:
        dqdt = dqdt + colp[None] * source
    if diff_coef is not None:
        dqdt = dqdt + horizontal_diffusion(q, colp[None], grid, diff_coef)
    return dqdt


def horizontal_diffusion(q, colp_face, grid: Grid, coef, is_v: bool = False):
    """COLP-weighted 5-point Laplacian smoothing: zero-flux at the lat walls
    via edge clamping for scalars and u; for v the wall value (0) is the
    neighbor beyond the last row. ``coef`` [m2 s-1] is a per-latitude (ny,)
    tensor or a scalar."""
    if isinstance(coef, torch.Tensor) and coef.ndim == 1:
        coef = _lat(coef)
    dx2 = _lat(grid.dx ** 2)
    north = bc.north_zero(q) if is_v else bc.north_clamp(q)
    lap = (bc.east(q) - 2.0 * q + bc.west(q)) / dx2 \
        + (north - 2.0 * q + bc.south_clamp(q)) / grid.dy ** 2
    return coef * colp_face * lap


# ---------------------------------------------------------------------------
# Momentum tendencies.
# ---------------------------------------------------------------------------

def momentum_tendency(u, v, pott, colp, cont: Continuity, diag: Diagnostics,
                      grid: Grid, diff_coef=None):
    """(dudt, dvdt) = d(COLP_face * wind)/dt [Pa m s-2]."""
    uflx, vflx, wwind, colp_new = cont.uflx, cont.vflx, cont.wwind, cont.colp_new
    area = _lat(grid.area)
    area_v = _lat(grid.area_v)
    dsig = _lev(grid.dsigma)
    colp_u = 0.5 * (bc.west(colp) + colp)[None]
    colp_v = 0.5 * (bc.south_clamp(colp) + colp)[None]

    # ---- u momentum ----
    fxc = 0.5 * (uflx + bc.east(uflx)) * 0.5 * (u + bc.east(u))
    fyc = 0.5 * (bc.west(vflx) + vflx) * 0.5 * (bc.south_clamp(u) + u)
    adv_u = -(fxc - bc.west(fxc) + bc.north_zero(fyc) - fyc) / area

    w_int = wwind[1:-1]
    w_u = 0.5 * (bc.west(w_int) + w_int)
    cn_u = 0.5 * (bc.west(colp_new) + colp_new)[None]
    fz_int = w_u * cn_u * 0.5 * (u[:-1] + u[1:])
    zero = torch.zeros_like(fz_int[:1])
    fz = torch.cat([zero, fz_int, zero], dim=0)
    vadv_u = -(fz[1:] - fz[:-1]) / dsig

    vn = bc.north_zero(v)
    v_at_u = 0.25 * (bc.west(v) + v + bc.west(vn) + vn)
    tanf = _lat(grid.tan_lat)
    cor_u = colp_u * (_lat(grid.corf) + u * tanf / c.R_EARTH) * v_at_u

    pott_u = 0.5 * (bc.west(pott) + pott)
    dx = _lat(grid.dx)
    pgf_u = -colp_u * ((diag.phi - bc.west(diag.phi))
                       + c.C_P * pott_u * (diag.pvtf - bc.west(diag.pvtf))) / dx

    dudt = adv_u + vadv_u + cor_u + pgf_u
    if diff_coef is not None:
        dudt = dudt + horizontal_diffusion(u, colp_u, grid, diff_coef)

    # ---- v momentum ----
    vflx_n = bc.north_zero(vflx)
    fyc_v = 0.5 * (vflx + vflx_n) * 0.5 * (v + bc.north_zero(v))
    fxc_v = 0.5 * (bc.south_clamp(uflx) + uflx) * 0.5 * (bc.west(v) + v)
    adv_v = -(bc.east(fxc_v) - fxc_v + fyc_v - bc.south_zero(fyc_v)) / area_v

    w_v = 0.5 * (bc.south_clamp(w_int) + w_int)
    cn_v = 0.5 * (bc.south_clamp(colp_new) + colp_new)[None]
    fz_int_v = w_v * cn_v * 0.5 * (v[:-1] + v[1:])
    fz_v = torch.cat([zero, fz_int_v, zero], dim=0)
    vadv_v = -(fz_v[1:] - fz_v[:-1]) / dsig

    ue = bc.east(u)
    u_at_v = 0.25 * (bc.south_clamp(u) + bc.south_clamp(ue) + u + ue)
    tanf_v = _lat(grid.tan_lat_v)
    cor_v = -colp_v * (_lat(grid.corf_v) + u_at_v * tanf_v / c.R_EARTH) * u_at_v

    pott_v = 0.5 * (bc.south_clamp(pott) + pott)
    pgf_v = -colp_v * ((diag.phi - bc.south_clamp(diag.phi))
                       + c.C_P * pott_v
                       * (diag.pvtf - bc.south_clamp(diag.pvtf))) / grid.dy

    dvdt = adv_v + vadv_v + cor_v + pgf_v
    if diff_coef is not None:
        dvdt = dvdt + horizontal_diffusion(v, colp_v, grid, diff_coef,
                                           is_v=True)
    dvdt = bc.enforce_v_walls(dvdt)
    return dudt, dvdt
