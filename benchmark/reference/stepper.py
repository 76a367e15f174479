"""Frozen copy of the Matsuno step of ``climate_model_tpu_torch/dycore/
stepper.py`` at commit dbbffa0 (``substep``, ``step_matsuno``): the
benchmark's plain reference imports nothing of the port.

Matsuno (Euler-backward) predictor-corrector in plain PyTorch.
"""

from __future__ import annotations

from .config import ModelConfig
from .grid import Grid
from .state import Forcing, State
from .tendencies import proceed, tendencies


def substep(ev: State, base: State, dt, grid: Grid, forcing: Forcing,
            cfg: ModelConfig) -> State:
    """One Matsuno substep: tendencies at ``ev``, advanced from ``base``
    (the same state for the predictor, the t_n state for the corrector)."""
    tend = tendencies(ev, base.colp, dt, grid, forcing, cfg)
    return proceed(base, tend, dt, moisture=cfg.numerics.moisture_tendency)


def step_matsuno(state: State, grid: Grid, forcing: Forcing,
                 cfg: ModelConfig) -> State:
    """Predictor = Euler estimate with tendencies at t_n; corrector
    re-evaluates tendencies at the predicted state and advances from the
    ORIGINAL t_n state."""
    pred = substep(state, state, grid.dt, grid, forcing, cfg)
    return substep(pred, state, grid.dt, grid, forcing, cfg)
