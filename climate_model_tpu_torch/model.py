"""Full model step: dynamics + operator-split physics + time bookkeeping.

Port of the per-step path of ``climate_model_tpu/model.py``: radiation on its
interval (a host-side ``if`` on the step counter), the dynamics step (the
fused substep kernel, predictor then corrector), then the surface, turbulence and microphysics splits. ``make_chunk_runner``
takes this per-step path unconditionally; the packed scan whose corrector
carries the physics as an epilogue comes with a later slice.
"""

from __future__ import annotations

from typing import Callable

from .core.config import ModelConfig, check_rad_resolved
from .core.grid import Grid
from .core.state import Forcing, State
from .dycore.operators import diagnose_pressure
from .dycore.stepper import dynamics_step_fn, run_scan
from .physics.microphysics import microphysics_step
from .physics.radiation import radiation_step
from .physics.surface import surface_step
from .physics.turbulence import turbulence_step


def make_step_fn(cfg: ModelConfig, dynamics=None
                 ) -> Callable[[State, Grid, Forcing], State]:
    """Build the full per-step function for ``cfg``. ``dynamics`` replaces
    the dynamics step (default: ``dynamics_step_fn(cfg)``, the substep
    kernels); a reference run passes the plain ``step_matsuno``."""
    check_rad_resolved(cfg)
    dyn_step = dynamics_step_fn(cfg) if dynamics is None else dynamics
    phys = cfg.physics
    any_split = phys.surface or phys.turbulence or phys.microphysics

    def step(state: State, grid: Grid, forcing: Forcing) -> State:
        dt = grid.dt
        if phys.radiation:
            state = radiation_step(state, grid, forcing, cfg)
        state = dyn_step(state, grid, forcing)
        if any_split:
            # COLP is fixed for the rest of the step: share the Exner/pressure
            # diagnostics across the physics splits
            press = diagnose_pressure(state.colp, grid)
        if phys.surface:
            state = surface_step(state, grid, forcing, cfg, dt, press=press)
        if phys.turbulence:
            state = turbulence_step(state, grid, forcing, cfg, dt, press=press)
        if phys.microphysics:
            state = microphysics_step(state, grid, forcing, cfg, dt,
                                      press=press)
        return state.replace(t=state.t + dt, step=state.step + 1)

    return step


def make_chunk_runner(cfg: ModelConfig, n_steps: int):
    """``run(state, grid, forcing) -> state`` advancing ``n_steps`` with the
    per-step path."""
    step = make_step_fn(cfg)

    def run(state: State, grid: Grid, forcing: Forcing) -> State:
        return run_scan(step, state, grid, forcing, n_steps)

    return run
