"""Tendency orchestration + mass-weighted update.

Port of ``climate_model_tpu/dycore/tendencies.py``. Tendencies may be
evaluated at a *predicted* state (Matsuno corrector) while the update
advances from the time-n state; mass consistency requires
COLP_new = COLP_base + dt*dCOLPdt (docs/NUMERICS.md, 'Continuity').
"""

from __future__ import annotations

import torch

from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from . import boundaries as bc
from . import operators as ops
from .operators import Tendencies


def tendencies(state: State, colp_base, dt, grid: Grid, forcing: Forcing,
               cfg: ModelConfig) -> Tendencies:
    """One full tendency evaluation at ``state``; ``cfg`` switches mirror the
    reference's per-tendency namelist flags."""
    num = cfg.numerics
    colp, pott = state.colp, state.pott

    diag = ops.diagnose(colp, pott, forcing.hsurf, grid)
    cont = ops.continuity(state.u, state.v, colp, colp_base, dt, grid)
    if not num.colp_tendency:
        cont = cont._replace(
            dcolpdt=torch.zeros_like(cont.dcolpdt),
            colp_new=colp_base,
            wwind=torch.zeros_like(cont.wwind),
        )

    # diffusion on/off follows the config floats; the VALUES applied are the
    # per-latitude Grid tensors (the substep kernel reads the same ones)
    kuv = grid.kdiff_uv if num.diff_uv else None
    kpott = grid.kdiff_pott if num.diff_pott else None
    kmoist = grid.kdiff_moist if num.diff_moist else None

    zeros3 = torch.zeros_like(pott)
    if num.wind_tendency:
        dudt, dvdt = ops.momentum_tendency(
            state.u, state.v, pott, colp, cont, diag, grid, diff_coef=kuv)
    else:
        dudt = dvdt = zeros3

    if num.temperature_tendency:
        src = state.dpottdt_rad if cfg.physics.radiation else None
        dpottdt = ops.scalar_tendency(pott, cont, colp, grid, source=src,
                                      diff_coef=kpott)
    else:
        dpottdt = zeros3

    if num.moisture_tendency:
        dqvdt = ops.scalar_tendency(state.qv, cont, colp, grid,
                                    diff_coef=kmoist)
        dqcdt = ops.scalar_tendency(state.qc, cont, colp, grid,
                                    diff_coef=kmoist)
    else:
        dqvdt = dqcdt = zeros3

    return Tendencies(dudt=dudt, dvdt=dvdt, dcolpdt=cont.dcolpdt,
                      dpottdt=dpottdt, dqvdt=dqvdt, dqcdt=dqcdt,
                      colp_new=cont.colp_new, wwind=cont.wwind)


def proceed(state: State, tend: Tendencies, dt, moisture: bool = True) -> State:
    """Mass-weighted prognostic update from ``state`` (time n):
    X_new = (X*COLP_face_old + dt*dXdt) / COLP_face_new, then QV/QC >= 0
    clipping and v-wall re-enforcement. The caller advances t and step."""
    colp_old, colp_new = state.colp, tend.colp_new

    cu_old = 0.5 * (bc.west(colp_old) + colp_old)[None]
    cu_new = 0.5 * (bc.west(colp_new) + colp_new)[None]
    cv_old = 0.5 * (bc.south_clamp(colp_old) + colp_old)[None]
    cv_new = 0.5 * (bc.south_clamp(colp_new) + colp_new)[None]

    u = (state.u * cu_old + dt * tend.dudt) / cu_new
    v = bc.enforce_v_walls((state.v * cv_old + dt * tend.dvdt) / cv_new)
    pott = (state.pott * colp_old[None] + dt * tend.dpottdt) / colp_new[None]
    out = state.replace(u=u, v=v, pott=pott, colp=colp_new)
    if moisture:
        qv = (state.qv * colp_old[None] + dt * tend.dqvdt) / colp_new[None]
        qc = (state.qc * colp_old[None] + dt * tend.dqcdt) / colp_new[None]
        out = out.replace(qv=torch.clamp(qv, min=0.0),
                          qc=torch.clamp(qc, min=0.0))
    return out
