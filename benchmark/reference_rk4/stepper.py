"""Frozen copy of the RK4 step of ``climate_model_tpu_torch/dycore/
stepper.py`` (``step_rk4``, as at commit 2220f31), over the frozen
tendencies of ``reference/tendencies.py``: the benchmark's plain reference
imports nothing of the port.

Classical RK4 on the conserved variables
y = (COLP, COLP_u*u, COLP_v*v, COLP*POTT, COLP*QV, COLP*QC); the
mass-weighted update is exactly d(COLP*X)/dt integration, so RK4 composes
linearly in y. Each stage's tendencies are evaluated at its own state with
COLP_new = COLP + dt*dCOLP/dt (the full dt) for the sigma velocity.
"""

from __future__ import annotations

import torch

from ..reference import boundaries as bc
from ..reference.config import ModelConfig
from ..reference.grid import Grid
from ..reference.state import Forcing, State
from ..reference.tendencies import tendencies


def step_rk4(state: State, grid: Grid, forcing: Forcing,
             cfg: ModelConfig) -> State:
    dt = grid.dt
    moist = cfg.numerics.moisture_tendency

    def to_conserved(s: State):
        cu = 0.5 * (bc.west(s.colp) + s.colp)[None]
        cv = 0.5 * (bc.south_clamp(s.colp) + s.colp)[None]
        return (s.colp, cu * s.u, cv * s.v, s.colp[None] * s.pott,
                s.colp[None] * s.qv, s.colp[None] * s.qc)

    def from_conserved(y) -> State:
        colp, U, V, P, Qv, Qc = y
        cu = 0.5 * (bc.west(colp) + colp)[None]
        cv = 0.5 * (bc.south_clamp(colp) + colp)[None]
        s = state.replace(colp=colp, u=U / cu,
                          v=bc.enforce_v_walls(V / cv), pott=P / colp[None])
        if moist:
            s = s.replace(qv=torch.clamp(Qv / colp[None], min=0.0),
                          qc=torch.clamp(Qc / colp[None], min=0.0))
        return s

    def f(y):
        s = from_conserved(y)
        t = tendencies(s, s.colp, dt, grid, forcing, cfg)
        return (t.dcolpdt, t.dudt, t.dvdt, t.dpottdt, t.dqvdt, t.dqcdt)

    y0 = to_conserved(state)

    def axpy(a, ydot):
        return tuple(yi + a * di for yi, di in zip(y0, ydot))

    k1 = f(y0)
    k2 = f(axpy(0.5 * dt, k1))
    k3 = f(axpy(0.5 * dt, k2))
    k4 = f(axpy(dt, k3))
    y1 = tuple(yi + (dt / 6.0) * (a + 2.0 * b + 2.0 * c + d)
               for yi, a, b, c, d in zip(y0, k1, k2, k3, k4))
    return from_conserved(y1)
