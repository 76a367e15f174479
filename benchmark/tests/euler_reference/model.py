"""A reference package for the tests of the choice of reference only: the
frozen reference with forward Euler in place of Matsuno, as the port's
plain ``step_euler`` has it (one substep with the tendencies at t_n). A
configuration names it as ``reference = "tests.euler_reference"``."""

from __future__ import annotations

from benchmark.reference.microphysics import microphysics_step
from benchmark.reference.model import (  # noqa: F401
    STATE_FIELDS, build, chunk_dt, make_state, reference_device)
from benchmark.reference.operators import diagnose_pressure
from benchmark.reference.radiation import radiation_step
from benchmark.reference.stepper import substep
from benchmark.reference.surface import surface_step
from benchmark.reference.turbulence import turbulence_step


def step(state, grid, forcing, cfg):
    """One full model step: ``reference/model.py::step`` with the Euler
    dynamics."""
    dt = grid.dt
    phys = cfg.physics
    if phys.radiation:
        state = radiation_step(state, grid, forcing, cfg)
    state = substep(state, state, dt, grid, forcing, cfg)
    press = diagnose_pressure(state.colp, grid)
    if phys.surface:
        state = surface_step(state, grid, forcing, cfg, dt, press=press)
    if phys.turbulence:
        state = turbulence_step(state, grid, forcing, cfg, dt, press=press)
    if phys.microphysics:
        state = microphysics_step(state, grid, forcing, cfg, dt, press=press)
    return state.replace(t=state.t + dt, step=state.step + 1)
