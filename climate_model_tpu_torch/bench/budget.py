"""Discrete budget-identity instrumentation.

Port of ``climate_model_tpu/bench/budget.py``. ``make_budget_scan`` steps
the model through its exact operator-split sequence (radiation -> dynamics
-> surface -> turbulence -> microphysics; ``model.py::make_step_fn`` order)
on the plain splits and records the global water and moist-energy totals
after every split, so that each split's budget increment can be held
against its exact discrete identity:

water (column qv+qc mass + accumulated-rain reservoir):
  * surface:      dW = dt * sum(evap * area), exactly (the same evap flux
                  and the same layer mass enter the qv update)
  * microphysics: dW = 0, exactly (saturation adjustment moves qv<->qc;
                  autoconversion moves qc -> rain with the same layer mass)
  * turbulence:   dW = 0 to roundoff (flux form in z) + the >= 0 clip
  * dynamics:     flux-form advection telescopes globally, so dW is the
                  qv/qc >= 0 clip gain plus the non-conservation of the
                  horizontal diffusion (not in flux form), both measured

moist energy (cp*T + L_V*qv column integral + slab heat content):
  * surface:      dE = dt * sum((swflx_sfc + lwflx_sfc) * area), exactly
  * microphysics: dE = 0, exactly
  * turbulence:   mixing theta conserves sum(theta*dp), not
                  sum(theta*pvtf*dp): a physical rearrangement, measured
  * dynamics:     adiabatic conversion + the applied radiative heating,
                  recorded apart (``e_rad_applied``) so it subtracts out

In fp32 on a card each global sum carries a reduction error of about
1e-7 of the total, so the identities there hold relative to W and E, not
to the increments (the reference's ``tests/tpu/test_budget_identity_tpu.py``
bounds).
"""

from __future__ import annotations

import torch

from ..core import constants as c
from ..core.config import ModelConfig, check_rad_resolved
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore.operators import diagnose_pressure

REC_KEYS = ("w_dyn", "w_srf", "w_trb", "w_mic", "w_srf_expect",
            "e_dyn", "e_srf", "e_trb", "e_mic", "e_srf_expect",
            "e_rad_applied", "w_total", "e_total")


def water_total(state: State, grid: Grid) -> torch.Tensor:
    """Global water [kg]: column (qv+qc) mass + accumulated-rain reservoir
    (the weighting of ``io/metrics.py`` diagnostics)."""
    area = grid.area[:, None]
    mass = state.colp[None] * grid.dsigma[:, None, None]
    return torch.sum((state.qv + state.qc) * mass * area[None]) / c.G \
        + torch.sum(state.rain * area)


def energy_total(state: State, grid: Grid, forcing: Forcing,
                 cfg: ModelConfig) -> torch.Tensor:
    """Global moist enthalpy + slab heat [J] (``io/metrics.py``'s
    ``energy`` integrand, in absolute units)."""
    area = grid.area[:, None]
    mass = state.colp[None] * grid.dsigma[:, None, None]
    _, pvtf, _ = diagnose_pressure(state.colp, grid)
    tair = state.pott * pvtf
    col = torch.sum((c.C_P * tair + c.L_V * state.qv) * mass
                    * area[None]) / c.G
    heat_cap = torch.where(
        forcing.land_mask > 0.5,
        torch.full_like(state.tsurf, cfg.physics.soil_heat_capacity),
        torch.full_like(state.tsurf, cfg.physics.ocean_heat_capacity))
    return col + torch.sum(heat_cap * state.tsurf * area)


def make_budget_scan(cfg: ModelConfig, n_steps: int):
    """Build ``run(state, grid, forcing) -> (state, rec)`` advancing
    ``n_steps`` through the exact ``make_step_fn`` split sequence, recording
    per-step budget increments. ``rec`` maps name -> (n_steps,) tensor on
    the state's device:

      w_dyn/w_srf/w_trb/w_mic   water increment of each split [kg]
      w_srf_expect              dt * sum(evap*area) (the exact identity)
      e_dyn/e_srf/e_trb/e_mic   energy increment of each split [J]
      e_srf_expect              dt * sum((sw+lw)_sfc * area)
      e_rad_applied             dt * sum(cp*colp*rad*pvtf*dsig/g * area)
                                (the radiative part of e_dyn)
      w_total/e_total           the totals after the step

    The dynamics step follows ``cfg.backend`` (``dycore/stepper.py::
    dynamics_step_fn``); the splits are the plain ones.
    """
    check_rad_resolved(cfg)
    from ..dycore.stepper import dynamics_step_fn
    from ..physics.microphysics import microphysics_step
    from ..physics.radiation import radiation_step
    from ..physics.surface import surface_fluxes, surface_step
    from ..physics.turbulence import turbulence_step

    dyn_step = dynamics_step_fn(cfg)
    phys = cfg.physics

    def step(state: State, grid: Grid, forcing: Forcing):
        area = grid.area[:, None]
        dt = grid.dt

        def W(s):
            return water_total(s, grid)

        def E(s):
            return energy_total(s, grid, forcing, cfg)

        w0, e0 = W(state), E(state)
        if phys.radiation:
            state = radiation_step(state, grid, forcing, cfg)
            # the radiative enthalpy injection the dynamics step is about
            # to apply (POTT tendency += colp * dpottdt_rad; weight pvtf)
            _, pvtf0, _ = diagnose_pressure(state.colp, grid)
            e_rad = dt * torch.sum(
                c.C_P * state.colp[None] * state.dpottdt_rad * pvtf0
                * grid.dsigma[:, None, None] * area[None]) / c.G
        else:
            e_rad = torch.zeros_like(e0)
        state = dyn_step(state, grid, forcing)
        w1, e1 = W(state), E(state)
        press = diagnose_pressure(state.colp, grid)
        if phys.surface:
            fx = surface_fluxes(state, grid, forcing, cfg, press=press)
            w_srf_expect = dt * torch.sum(fx.evap * area)
            e_srf_expect = dt * torch.sum(
                (state.swflx_sfc + state.lwflx_sfc) * area)
            state = surface_step(state, grid, forcing, cfg, dt, press=press)
        else:
            w_srf_expect = e_srf_expect = torch.zeros_like(w0)
        w2, e2 = W(state), E(state)
        if phys.turbulence:
            state = turbulence_step(state, grid, forcing, cfg, dt,
                                    press=press)
        w3, e3 = W(state), E(state)
        if phys.microphysics:
            state = microphysics_step(state, grid, forcing, cfg, dt,
                                      press=press)
        w4, e4 = W(state), E(state)
        state = state.replace(t=state.t + dt, step=state.step + 1)
        rec = dict(
            w_dyn=w1 - w0, w_srf=w2 - w1, w_trb=w3 - w2, w_mic=w4 - w3,
            w_srf_expect=w_srf_expect,
            e_dyn=e1 - e0, e_srf=e2 - e1, e_trb=e3 - e2, e_mic=e4 - e3,
            e_srf_expect=e_srf_expect, e_rad_applied=e_rad,
            w_total=w4, e_total=e4)
        return state, rec

    def run(state: State, grid: Grid, forcing: Forcing):
        recs = {k: [] for k in REC_KEYS}
        for _ in range(n_steps):
            state, rec = step(state, grid, forcing)
            for k in REC_KEYS:
                recs[k].append(rec[k])
        return state, {k: torch.stack(v) for k, v in recs.items()}

    return run
