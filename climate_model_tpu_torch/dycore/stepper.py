"""Time integration: Matsuno predictor-corrector and the chunk loop.

Port of the Matsuno half of ``climate_model_tpu/dycore/stepper.py``. The
reference's ``lax.scan`` loop is a Python loop (``run_scan``). The dynamics
step is the fused substep kernel, launched twice a step (predictor, then
corrector) on the plain State layout (``kernels/fused_substep.py``); on CPU
tensors the kernel wrappers take the plain ``substep``. ``step_matsuno`` is
the plain step: the reference the tests and ``chip_smoke.py`` hold the
kernel path against, and the CPU path for the per-term tendency switches.
Euler and RK4 come in a later slice.
"""

from __future__ import annotations

from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from .tendencies import proceed, tendencies


def substep(ev: State, base: State, dt, grid: Grid, forcing: Forcing,
            cfg: ModelConfig) -> State:
    """One Matsuno substep in plain PyTorch: tendencies at ``ev``, advanced
    from ``base`` (the same state for the predictor, the t_n state for the
    corrector)."""
    tend = tendencies(ev, base.colp, dt, grid, forcing, cfg)
    return proceed(base, tend, dt, moisture=cfg.numerics.moisture_tendency)


def step_matsuno(state: State, grid: Grid, forcing: Forcing,
                 cfg: ModelConfig) -> State:
    """Matsuno (Euler-backward) predictor-corrector: predictor = Euler
    estimate with tendencies at t_n; corrector re-evaluates tendencies at the
    predicted state and advances from the ORIGINAL t_n state."""
    pred = substep(state, state, grid.dt, grid, forcing, cfg)
    return substep(pred, state, grid.dt, grid, forcing, cfg)


def _fused_matsuno_step_fn(cfg: ModelConfig):
    """Matsuno stepper on the fused substep kernel: one predictor launch and
    one corrector launch per step; physics sources/splits stay around it."""
    from ..kernels.fused_substep import corrector, predictor

    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))

    def step(state: State, grid: Grid, forcing: Forcing) -> State:
        p = predictor(state, grid, forcing, grid.dt, **kw)
        return corrector(p, state, grid, forcing, grid.dt, **kw)

    return step


def dynamics_step_fn(cfg: ModelConfig):
    """The dynamics stepper for ``cfg``: ``step(state, grid, forcing)``.
    It launches the substep kernels; only a config that turns a tendency
    off (a debug switch the kernel does not carry) takes the plain
    ``step_matsuno``, and that on the CPU only."""
    num = cfg.numerics
    if num.time_stepping != "matsuno":
        raise ValueError(f"time_stepping {num.time_stepping!r} is not ported "
                         "yet; choose from ['matsuno']")
    if (num.wind_tendency and num.colp_tendency and num.temperature_tendency
            and num.moisture_tendency):
        return _fused_matsuno_step_fn(cfg)

    def step(state: State, grid: Grid, forcing: Forcing) -> State:
        if state.u.device.type != "cpu":
            raise ValueError("the per-tendency switches are a CPU debug "
                             "feature: the substep kernel computes every "
                             "tendency")
        return step_matsuno(state, grid, forcing, cfg)

    return step


def run_scan(step_fn, state: State, grid: Grid, forcing: Forcing,
             n_steps: int) -> State:
    """Run ``n_steps`` of ``step_fn`` (the reference's ``lax.scan``)."""
    for _ in range(n_steps):
        state = step_fn(state, grid, forcing)
    return state
