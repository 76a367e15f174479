"""Moist-thermodynamics helpers (Magnus saturation formula).

Port of ``climate_model_tpu/physics/thermo.py``. The reference's pluggable
``xp`` module becomes ``torch`` for the model; the initial conditions, which
are built in float64 NumPy, pass ``xp=numpy``.
"""

from __future__ import annotations

import torch

from ..core import constants as c


def esat_water(tair, xp=torch):
    """Saturation vapor pressure over water [Pa], Magnus formula."""
    t_c = tair - c.T_ZERO_C
    return c.MAGNUS_E0 * xp.exp(c.MAGNUS_A * t_c / (t_c + c.MAGNUS_B))


def qsat_water(tair, pair, xp=torch):
    """Saturation mixing ratio [kg/kg]:
    q_sat = eps * e_sat / (p - (1 - eps) * e_sat)."""
    es = esat_water(tair, xp)
    denom = pair - (1.0 - c.EPS_V) * es
    if xp is torch:
        denom = torch.clamp(denom, min=1.0)
    else:
        denom = xp.maximum(denom, 1.0)
    return c.EPS_V * es / denom
