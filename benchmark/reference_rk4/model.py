"""The plain reference model of the RK4 configuration: ``reference/model.py``
with the RK4 dynamics (``stepper.py``), as the port's per-step path runs
``step_rk4`` (``climate_model_tpu_torch/model.py::make_step_fn``): radiation
on its interval, RK4, then the surface, turbulence and microphysics splits.
Grid, forcing, state and the host loop's dt rule are ``reference/``'s."""

from __future__ import annotations

from ..reference.microphysics import microphysics_step
from ..reference.model import (  # noqa: F401
    STATE_FIELDS, build, chunk_dt, make_state, reference_device)
from ..reference.operators import diagnose_pressure
from ..reference.radiation import radiation_step
from ..reference.surface import surface_step
from ..reference.turbulence import turbulence_step
from .stepper import step_rk4


def step(state, grid, forcing, cfg):
    """One full model step with the RK4 dynamics."""
    dt = grid.dt
    phys = cfg.physics
    if phys.radiation:
        state = radiation_step(state, grid, forcing, cfg)
    state = step_rk4(state, grid, forcing, cfg)
    press = diagnose_pressure(state.colp, grid)
    if phys.surface:
        state = surface_step(state, grid, forcing, cfg, dt, press=press)
    if phys.turbulence:
        state = turbulence_step(state, grid, forcing, cfg, dt, press=press)
    if phys.microphysics:
        state = microphysics_step(state, grid, forcing, cfg, dt, press=press)
    return state.replace(t=state.t + dt, step=state.step + 1)
