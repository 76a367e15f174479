"""Time integration: Matsuno predictor-corrector, Euler, RK4; the chunk loop.

Port of ``climate_model_tpu/dycore/stepper.py``. The reference's
``lax.scan`` loop is a Python loop (``run_scan``). With ``backend='pallas'``
the dynamics step is the fused substep kernel on the plain State layout
(``kernels/fused_substep.py``), launched twice a step for Matsuno
(predictor, then corrector), or the RK4 stage kernel, launched four times a
step for RK4 (on one device only: it has no shard-local or seam-strip
variant); on CPU tensors the kernel wrappers take their plain versions.
That backend refuses Euler, as the reference's does. ``step_matsuno``,
``step_euler`` and ``step_rk4`` are the plain steps: what
``backend='jnp'`` runs on whatever device the state is on (the per-term
tendency switches included); ``step_matsuno`` and ``step_rk4`` are also
the references the tests and ``chip_smoke.py`` hold the kernel paths
against.
"""

from __future__ import annotations

import torch

from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from . import boundaries as bc
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


def step_euler(state: State, grid: Grid, forcing: Forcing,
               cfg: ModelConfig) -> State:
    """Forward Euler: one substep with the tendencies at t_n."""
    return substep(state, state, grid.dt, grid, forcing, cfg)


def step_rk4(state: State, grid: Grid, forcing: Forcing,
             cfg: ModelConfig) -> State:
    """Classical RK4 on the conserved variables
    y = (COLP, COLP_u*u, COLP_v*v, COLP*POTT, COLP*QV, COLP*QC); the
    mass-weighted update is exactly d(COLP*X)/dt integration, so RK4
    composes linearly in y."""
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


_STEPPERS = {"matsuno": step_matsuno, "euler": step_euler, "rk4": step_rk4}


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


def _fused_rk4_step_fn(cfg: ModelConfig):
    """RK4 stepper on the stage kernel: four launches a step, the
    accumulator allocated a step; physics sources/splits stay around it."""
    from ..kernels.fused_substep import rk4_accumulator, rk4_stage

    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))

    def step(state: State, grid: Grid, forcing: Forcing) -> State:
        acc = rk4_accumulator(state)
        s = state
        for stage in (1, 2, 3, 4):
            s = rk4_stage(s, state, acc, grid, forcing, grid.dt,
                          stage=stage, **kw)
        return s

    return step


_FUSED = {"matsuno": _fused_matsuno_step_fn, "rk4": _fused_rk4_step_fn}


def check_pallas(cfg: ModelConfig) -> None:
    """The refusals of ``backend='pallas'``: the kernels carry Matsuno and
    RK4 (the reference's carry Matsuno only,
    ``climate_model_tpu/dycore/stepper.py:145-154``), RK4 on one device
    only, and every tendency."""
    num = cfg.numerics
    if num.time_stepping not in _FUSED:
        raise ValueError("backend='pallas' supports matsuno and rk4 only, "
                         f"not {num.time_stepping!r}")
    sh = cfg.sharding
    if num.time_stepping == "rk4" and sh.mesh_lat * sh.mesh_lon > 1:
        raise ValueError("backend='pallas' runs rk4 on one device only: the "
                         "RK4 stage kernel has no shard-local or seam-strip "
                         f"variant (mesh {sh.mesh_lat}x{sh.mesh_lon})")
    if not (num.wind_tendency and num.colp_tendency
            and num.temperature_tendency and num.moisture_tendency):
        raise ValueError("backend='pallas' requires all tendencies on "
                         "(per-term switches are a jnp-backend debug "
                         "feature)")


def dynamics_step_fn(cfg: ModelConfig):
    """The dynamics stepper for ``cfg``: ``step(state, grid, forcing)``.
    As in the reference, ``cfg.backend`` decides: ``'pallas'`` launches the
    kernels of ``cfg.numerics.time_stepping`` (the Matsuno substeps or the
    RK4 stages; on CPU tensors their plain versions) and refuses what they
    do not carry (``check_pallas``); any other backend (``'jnp'``) takes
    the plain step of ``cfg.numerics.time_stepping`` (``_STEPPERS``) on
    whatever device the state is on."""
    if cfg.backend == "pallas":
        check_pallas(cfg)
        return _FUSED[cfg.numerics.time_stepping](cfg)
    ts = cfg.numerics.time_stepping
    try:
        raw = _STEPPERS[ts]
    except KeyError:
        raise ValueError(f"unknown time_stepping {ts!r}; choose from "
                         f"{sorted(_STEPPERS)}") from None

    def step(state: State, grid: Grid, forcing: Forcing) -> State:
        return raw(state, grid, forcing, cfg)

    return step


def run_scan(step_fn, state: State, grid: Grid, forcing: Forcing,
             n_steps: int) -> State:
    """Run ``n_steps`` of ``step_fn`` (the reference's ``lax.scan``)."""
    for _ in range(n_steps):
        state = step_fn(state, grid, forcing)
    return state
