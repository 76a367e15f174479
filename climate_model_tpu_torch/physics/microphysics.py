"""Microphysics: saturation adjustment + autoconversion to surface rain.

Port of ``climate_model_tpu/physics/microphysics.py``: condensation QV->QC
with latent heating of POTT, evaporation QC->QV, conversion of QC to
accumulated surface RAIN, QV/QC >= 0 clipping, and the rain refill of the
soil bucket (operator split, column-local).
"""

from __future__ import annotations

import math

import torch

from ..core import constants as c
from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import State
from ..dycore import operators as ops
from ..trace import count
from .thermo import qsat_water


def saturation_adjustment(pott, qv, qc, pvtf, pair, dt, cfg: ModelConfig):
    """One saturation adjustment step. Returns (pott, qv, qc, to_rain)."""
    tair = pott * pvtf
    qsat = qsat_water(tair, pair)
    # single Newton step with latent-heat feedback
    gamma = 1.0 + (c.L_V ** 2) * qsat / (c.C_P * c.R_V * tair ** 2)
    dq = (qv - qsat) / gamma
    cond = torch.clamp(dq, min=0.0)
    evap = torch.minimum(qc, torch.clamp(-dq, min=0.0))
    dqc = cond - evap
    qv = qv - dqc
    qc = qc + dqc
    pott = pott + (c.L_V / c.C_P) * dqc / pvtf

    # autoconversion: cloud water above threshold rains out with timescale tau
    p = cfg.physics
    frac = 1.0 - math.exp(-dt / p.qc_autoconv_time)
    to_rain = torch.clamp(qc - p.qc_autoconv_threshold, min=0.0) * frac
    qc = qc - to_rain
    return pott, qv, qc, to_rain


def microphysics_step(state: State, grid: Grid, forcing, cfg: ModelConfig,
                      dt, press=None) -> State:
    """Saturation adjustment, autoconversion, rain and the soil refill.
    The counter ``microphysics.calls`` (``trace.py``) counts the calls."""
    count("microphysics.calls")
    pvb, pvtf, _ = press if press is not None \
        else ops.diagnose_pressure(state.colp, grid)
    pair = 0.5 * (pvb[:-1] + pvb[1:])
    pott, qv, qc, to_rain = saturation_adjustment(
        state.pott, state.qv, state.qc, pvtf, pair, dt, cfg)
    # rain accumulates as column-integrated removed water [kg m-2]
    dp = state.colp[None] * grid.dsigma[:, None, None]
    rain_inc = torch.sum(to_rain * dp, dim=0) / c.G
    rain = state.rain + rain_inc

    p = cfg.physics
    soil_moist = state.soil_moist
    if p.surface and p.soil_moisture:
        wetted = torch.clamp(soil_moist + rain_inc / c.RHO_WATER,
                             max=p.soil_moist_cap)
        soil_moist = torch.where(forcing.land_mask > 0.5, wetted, soil_moist)
    return state.replace(pott=pott, qv=torch.clamp(qv, min=0.0),
                         qc=torch.clamp(qc, min=0.0), rain=rain,
                         soil_moist=soil_moist)
