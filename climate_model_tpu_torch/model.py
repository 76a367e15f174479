"""Full model step: dynamics + operator-split physics + time bookkeeping.

Port of ``climate_model_tpu/model.py``. Two paths, as in the reference:

* The **packed scan** (``make_packed_step_fn``), which ``make_chunk_runner``
  takes for every config the kernels cover (Matsuno, every tendency on), as
  the reference's default does (``CLIMATE_TPU_PACKED_SCAN=1``). A step is
  radiation on its interval, the predictor kernel, then one corrector that
  also runs surface, turbulence and microphysics as its epilogue, with the
  v wall passed as a row mask. The reference runs it on its packed
  supertensor layout (``kernels/packing.py``); the port runs the same
  program on its plain ``(nz, ny, nx)`` State layout, so there is nothing
  to pack. The reference's ``physics/packed.py`` (``radiation_step_packed``,
  ``compute_radiation_packed``, ``packed_pressure``) is the same math as
  ``physics/radiation.py`` on the packed layout; on the plain layout its
  counterpart is the port's ``radiation_step``, which gates on the same
  ``step % rad_every_steps`` and writes the same three caches.
* The **per-step path** (``make_step_fn`` + ``run_scan``, the reference's
  ``CLIMATE_TPU_PACKED_SCAN=0``): radiation, the dynamics step (the substep
  kernels, predictor then corrector), then the surface, turbulence and
  microphysics splits in plain PyTorch. It serves the per-tendency debug
  switches (CPU only), reference runs with the plain ``step_matsuno``, and
  ``chip_smoke.py``, which drives it beside the packed scan.
"""

from __future__ import annotations

from typing import Callable

from .core.config import ModelConfig, check_rad_resolved
from .core.grid import Grid
from .core.state import Forcing, State
from .dycore.operators import diagnose_pressure
from .dycore.stepper import dynamics_step_fn, run_scan
from .kernels.fused_substep import corrector, predictor, wall_mask
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


def phys_epilogue_tuple(cfg: ModelConfig):
    """Physics-epilogue parameters of the corrector kernel
    (``kernels/fused_substep.py``, ``phys=``; order ``PHYS_FIELDS``), or
    None if no split physics is on."""
    phys = cfg.physics
    if not (phys.surface or phys.turbulence or phys.microphysics):
        return None
    return (phys.surface, phys.turbulence, phys.microphysics,
            phys.drag_coef, phys.soil_heat_capacity,
            phys.ocean_heat_capacity, phys.qc_autoconv_time,
            phys.qc_autoconv_threshold, phys.diff_coef_scalar,
            phys.diff_coef_momentum,
            phys.surface and phys.soil_moisture, phys.soil_moist_cap,
            phys.turbulence and phys.convection, phys.conv_diffusivity,
            phys.conv_rh_crit)


def make_packed_step_fn(cfg: ModelConfig):
    """Full model step of the packed scan: radiation on its interval, the
    predictor kernel, then the corrector kernel with the physics epilogue
    (surface + turbulence + microphysics in the same call). The name is the
    reference's; the port's "packed" step runs on the plain State layout.
    Returns ``step(state, grid, forcing, vmask)``, ``vmask`` the v-wall row
    mask (``kernels.fused_substep.wall_mask``). Without split physics the
    corrector runs without the epilogue, still with the mask."""
    check_rad_resolved(cfg)
    num, phys = cfg.numerics, cfg.physics
    phys_tuple = phys_epilogue_tuple(cfg)
    kw = dict(with_rad=phys.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))

    def step(state: State, grid: Grid, forcing: Forcing, vmask) -> State:
        dt = grid.dt
        if phys.radiation:
            state = radiation_step(state, grid, forcing, cfg)
        p = predictor(state, grid, forcing, dt, vmask=vmask, **kw)
        state = corrector(p, state, grid, forcing, dt, phys=phys_tuple,
                          vmask=vmask, **kw)
        return state.replace(t=state.t + dt, step=state.step + 1)

    return step


def takes_packed_scan(cfg: ModelConfig) -> bool:
    """Whether ``make_chunk_runner`` takes the packed scan: the kernels
    cover Matsuno with every tendency on; the per-tendency switches are a
    debug feature of the per-step path."""
    num = cfg.numerics
    return (num.time_stepping == "matsuno" and num.wind_tendency
            and num.colp_tendency and num.temperature_tendency
            and num.moisture_tendency)


def make_chunk_runner(cfg: ModelConfig, n_steps: int):
    """``run(state, grid, forcing) -> state`` advancing ``n_steps``: the
    packed scan where ``takes_packed_scan(cfg)``, else the per-step path."""
    if not takes_packed_scan(cfg):
        step = make_step_fn(cfg)

        def run(state: State, grid: Grid, forcing: Forcing) -> State:
            return run_scan(step, state, grid, forcing, n_steps)

        return run

    pstep = make_packed_step_fn(cfg)

    def run(state: State, grid: Grid, forcing: Forcing) -> State:
        vmask = wall_mask(state.v.shape[-2], state.dtype, state.device)
        for _ in range(n_steps):
            state = pstep(state, grid, forcing, vmask)
        return state

    return run
