"""Full model step: dynamics + operator-split physics + time bookkeeping.

Port of ``climate_model_tpu/model.py``. Two paths, as in the reference:

* The **packed scan** (``make_packed_step_fn``), which ``make_chunk_runner``
  takes for every ``backend='pallas'`` config, as the reference's default
  does (``CLIMATE_TPU_PACKED_SCAN=1``); on a device mesh its sharded form,
  ``dist/packed_halo.py::make_packed_sharded_runner``. A step is
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
  ``CLIMATE_TPU_PACKED_SCAN=0``): radiation, the dynamics step, then the
  surface, turbulence and microphysics splits in plain PyTorch. The
  dynamics step follows ``cfg.backend`` (``dycore/stepper.py::
  dynamics_step_fn``): the substep kernels for ``'pallas'``, the plain
  ``step_matsuno`` for ``'jnp'``, which is what ``make_chunk_runner`` runs
  for a ``'jnp'`` config on any device. ``chip_smoke.py`` also drives it
  with the kernels beside the packed scan.

``make_run_fn`` is the reference's name for the chunk runner (the bench's
stability probe uses it).
"""

from __future__ import annotations

from typing import Callable

from .core.config import ModelConfig, check_rad_resolved
from .core.grid import Grid
from .core.state import Forcing, State
from .dycore.operators import diagnose_pressure
from .dycore.stepper import check_pallas, dynamics_step_fn, run_scan
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


# What a device mesh with backend='jnp' raises (the reference's per-operator
# halo path and GSPMD 'auto' are the next slice of the port).
JNP_MESH_NOT_PORTED = ("a device mesh with backend='jnp' (dist/halo.py, "
                       "GSPMD 'auto') is not ported yet; use "
                       "backend='pallas'")


def takes_packed_scan(cfg: ModelConfig) -> bool:
    """Whether ``make_chunk_runner`` takes the packed scan (sharded on a
    mesh): for ``backend='pallas'``, as in the reference
    (``climate_model_tpu/model.py:151``). Such a config must also pass
    ``check_pallas``."""
    return cfg.backend == "pallas"


def make_chunk_runner(cfg: ModelConfig, n_steps: int):
    """``run(state, grid, forcing) -> state`` advancing ``n_steps``.

    * ``backend='pallas'`` on one device: the packed scan; it raises the
      reference's errors for what the kernels do not carry.
    * ``backend='pallas'`` on a mesh (``mesh_lat * mesh_lon > 1``): the
      sharded packed scan (``dist/packed_halo.py``), whatever the sharding
      mode, as the reference's CLI takes it (``cli.py:181-192``). Its
      ``run`` takes and returns a ``dist.sharding.ShardedState``, or a
      global ``State`` that it splits and gathers around the run.
    * any other backend (``'jnp'``): the per-step path with the plain
      dynamics, on whatever device the state is on. On a mesh that is the
      reference's per-operator halo path or GSPMD ``auto``, not ported
      yet."""
    sh = cfg.sharding
    sharded = sh.mesh_lat * sh.mesh_lon > 1
    if not takes_packed_scan(cfg):
        if sharded:
            raise NotImplementedError(JNP_MESH_NOT_PORTED)
        step = make_step_fn(cfg)

        def run(state: State, grid: Grid, forcing: Forcing) -> State:
            return run_scan(step, state, grid, forcing, n_steps)

        return run

    check_pallas(cfg)
    if sharded:
        from .dist.packed_halo import make_packed_sharded_runner
        return make_packed_sharded_runner(cfg, n_steps)
    pstep = make_packed_step_fn(cfg)

    def run(state: State, grid: Grid, forcing: Forcing) -> State:
        vmask = wall_mask(state.v.shape[-2], state.dtype, state.device)
        for _ in range(n_steps):
            state = pstep(state, grid, forcing, vmask)
        return state

    return run


def make_run_fn(cfg: ModelConfig, n_steps: int, donate: bool = True):
    """``run(state, grid, forcing) -> state`` advancing ``n_steps``: the
    chunk runner of ``make_chunk_runner``. ``donate`` is the reference's
    (it donates the state's buffers to the jitted run) and does nothing
    here: the port updates no buffer in place that the caller still holds,
    so the caller's state stays valid either way."""
    del donate
    return make_chunk_runner(cfg, n_steps)
