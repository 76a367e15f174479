"""Full model step: dynamics + operator-split physics + time bookkeeping.

Port of ``climate_model_tpu/model.py``. Two paths, as in the reference:

* The **packed scan**, which ``make_chunk_runner`` takes for every
  ``backend='pallas'`` config, as the reference's default does
  (``CLIMATE_TPU_PACKED_SCAN=1``). Its step is one interface over a list
  of blocks, ``step(states, radiation, *, scalars=None, outs=None)``, with
  two implementations: ``PackedStep`` on one device and, on a device mesh,
  ``dist/packed_halo.py::ShardStep``. One eager loop, ``run_packed``,
  runs either, and one compiled runner (``graphs.py``) captures either. A
  Matsuno step is radiation on its interval, the predictor kernel, then
  one corrector that also runs surface, turbulence and microphysics as its
  epilogue, with the v wall passed as a row mask. An RK4 step (one device)
  is radiation on its interval, the four RK4 stage launches, then the same
  epilogue launched on the last stage's output: the per-step path's
  surface, turbulence and microphysics splits after ``step_rk4``. The
  reference runs its step on its packed supertensor layout
  (``kernels/packing.py``); the port runs the same program on its plain
  ``(nz, ny, nx)`` State layout, so there is nothing to pack. The
  reference's ``physics/packed.py`` (``radiation_step_packed``,
  ``compute_radiation_packed``, ``packed_pressure``) is the same math as
  ``physics/radiation.py`` on the packed layout; on the plain layout its
  counterpart is the port's ``radiation_step``, which gates on the same
  ``step % rad_every_steps`` and writes the same three caches.
* The **per-step path** (``make_step_fn`` + ``run_scan``, the reference's
  ``CLIMATE_TPU_PACKED_SCAN=0``): radiation, the dynamics step, then the
  surface, turbulence and microphysics splits in plain PyTorch. The
  dynamics step follows ``cfg.backend`` (``dycore/stepper.py::
  dynamics_step_fn``): the substep or stage kernels for ``'pallas'``, the
  plain step of ``cfg.numerics.time_stepping`` for ``'jnp'``, which is
  what ``make_chunk_runner`` runs for a ``'jnp'`` config on any device.
  ``chip_smoke.py`` also drives it with the kernels beside the packed
  scan.

On a CUDA device ``make_chunk_runner`` runs the packed scan, one card or
sharded, as the **compiled chunk** (``graphs.py``): the port's counterpart
of the reference's jitted chunk programs, a CUDA graph of the step per
buffer parity and radiation variant, replayed once a step, with ``dt`` a
runtime operand. ``graphs=False`` asks for the eager loop, which is the
yardstick the gates hold the graphs to; on the CPU there are no graphs and
the runner is the eager loop. ``takes_graphs`` makes that choice.

``make_run_fn`` is the reference's name for the chunk runner (the bench's
stability probe uses it).
"""

from __future__ import annotations

from typing import Callable

import torch

from .core.config import ModelConfig, check_rad_resolved
from .core.grid import Grid
from .core.state import Forcing, State
from .dist.mesh import in_process_group
from .dycore.operators import diagnose_pressure
from .dycore.stepper import check_pallas, dynamics_step_fn, run_scan
from .kernels.fused_substep import (ACC_FIELDS, corrector, epilogue,
                                    geo_table, predictor, rk4_accumulator,
                                    rk4_stage, wall_mask)
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


def packed_dynamics_fn(cfg: ModelConfig):
    """The kernels of a packed-scan step: for Matsuno the predictor, then
    the corrector with the physics epilogue; for RK4 the four stages, then
    the epilogue (``_rk4_dynamics_fn``). Returns ``dyn(state, grid,
    forcing, vmask, **launch)``, the step's state before ``t`` advances;
    ``launch`` passes ``scalars``, ``geo`` and ``out`` to the wrappers, and
    for RK4 ``work`` (``packed_work``): a captured step's (``graphs.py``)."""
    if cfg.numerics.time_stepping == "rk4":
        return _rk4_dynamics_fn(cfg)
    num, phys = cfg.numerics, cfg.physics
    phys_tuple = phys_epilogue_tuple(cfg)
    kw = dict(with_rad=phys.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))

    def dyn(state: State, grid: Grid, forcing: Forcing, vmask, *,
            out=None, **launch) -> State:
        dt = grid.dt
        p = predictor(state, grid, forcing, dt, vmask=vmask, **kw, **launch)
        return corrector(p, state, grid, forcing, dt, phys=phys_tuple,
                         vmask=vmask, out=out, **kw, **launch)

    return dyn


def packed_work(cfg: ModelConfig, state: State) -> dict:
    """The buffers a packed-scan step of ``cfg`` needs beyond the state's,
    as keyword arguments of its ``dyn``: none for Matsuno; for RK4
    ``work``, two stage states (u, v, pott, qv, qc and colp), which the
    stages write in turns, and the accumulator."""
    if cfg.numerics.time_stepping != "rk4":
        return {}
    return dict(work=dict(stages=tuple(rk4_accumulator(state)
                                       for _ in range(2)),
                          acc=rk4_accumulator(state)))


def _rk4_dynamics_fn(cfg: ModelConfig):
    """The RK4 packed-scan step's kernels: stages 1 and 3 write the first
    stage state of ``work``, 2 and 4 the second (with ``out``, stage 4
    writes colp there), then the epilogue, from the last stage's state, the
    rest of ``out``."""
    num = cfg.numerics
    phys_tuple = phys_epilogue_tuple(cfg)
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))

    def dyn(state: State, grid: Grid, forcing: Forcing, vmask, *,
            out=None, work=None, scalars=None, geo=None) -> State:
        dt = grid.dt
        work = packed_work(cfg, state)["work"] if work is None else work
        s = state
        for stage in (1, 2, 3, 4):
            dest = work["stages"][(stage - 1) % 2]
            if stage == 4 and out is not None:
                dest = {f: out[f] if phys_tuple is None or f == "colp"
                        else dest[f] for f in ACC_FIELDS}
            s = rk4_stage(s, state, work["acc"], grid, forcing, dt,
                          stage=stage, vmask=vmask, scalars=scalars,
                          geo=geo, out=dest, **kw)
        if phys_tuple is None:
            return s
        return epilogue(s, grid, forcing, dt, phys=phys_tuple, vmask=vmask,
                        scalars=scalars,
                        out=None if out is None else
                        {f: t for f, t in out.items() if f != "colp"})

    return dyn


class PackedStep:
    """One step of the packed scan on one device, with ``ShardStep``'s
    interface over a list of one block: ``step([state], radiation, *,
    scalars=None, outs=None)`` runs ``radiation(0, state)`` (the refresh on
    its interval) and ``packed_dynamics_fn``'s kernels, and returns the
    step's ``[state]`` before ``t`` advances; ``scalars`` is the ``(dt,
    frac)`` operand and ``outs[0]`` the tensors the step writes.

    The eager loop makes one a chunk. A captured step (``graphs.py``) makes
    one at capture with ``static=True``, which computes the geometry table
    once and holds the buffers the step needs beyond the state's
    (``packed_work``: for RK4 its stage states and accumulator)."""

    def __init__(self, cfg: ModelConfig, state: State, grid: Grid,
                 forcing: Forcing, static: bool = False):
        self.cfg = cfg
        self.dyn = packed_dynamics_fn(cfg)
        self.grids, self.forcings = [grid], [forcing]
        self.vmask = wall_mask(state.v.shape[-2], state.dtype, state.device)
        self.launch = dict(geo=geo_table(grid), **packed_work(cfg, state)) \
            if static else {}

    def __call__(self, states: list, radiation, *, scalars=None,
                 outs: list | None = None) -> list:
        (state,) = states
        if self.cfg.physics.radiation:
            state = radiation(0, state)
        return [self.dyn(state, self.grids[0], self.forcings[0], self.vmask,
                         scalars=scalars,
                         out=None if outs is None else outs[0],
                         **self.launch)]


def run_packed(cfg: ModelConfig, step, states: list, dt: float,
               n_steps: int) -> list:
    """The eager packed scan: ``n_steps`` of ``step`` (``PackedStep`` or
    ``ShardStep``) on the blocks ``states``, each step's radiation by
    ``radiation_step`` on the blocks' step counter, then ``t + dt`` and
    ``step + 1`` on every block."""

    def radiation(i: int, state: State) -> State:
        return radiation_step(state, step.grids[i], step.forcings[i], cfg)

    for _ in range(n_steps):
        states = [s.replace(t=s.t + dt, step=s.step + 1)
                  for s in step(states, radiation)]
    return states


def _packed_runner(cfg: ModelConfig, n_steps: int):
    """The eager packed scan on one device: ``run(state, grid, forcing)``
    advancing ``n_steps``."""
    check_rad_resolved(cfg)

    def run(state: State, grid: Grid, forcing: Forcing) -> State:
        (out,) = run_packed(cfg, PackedStep(cfg, state, grid, forcing),
                            [state], grid.dt, n_steps)
        return out

    return run


def make_packed_step_fn(cfg: ModelConfig):
    """Full model step of the packed scan on one device, ``step(state,
    grid, forcing) -> state``: one step of the eager loop on ``PackedStep``
    (radiation on its interval; for Matsuno the predictor, then the
    corrector with the physics epilogue; for RK4 the four stages and the
    epilogue). The name is the reference's; the port's "packed" step runs
    on the plain State layout."""
    return _packed_runner(cfg, 1)


def takes_packed_scan(cfg: ModelConfig) -> bool:
    """Whether ``make_chunk_runner`` takes the packed scan (sharded on a
    mesh): for ``backend='pallas'``, as in the reference
    (``climate_model_tpu/model.py:151``). Such a config must also pass
    ``check_pallas``."""
    return cfg.backend == "pallas"


def takes_graphs(cfg: ModelConfig, device, graphs: bool | None = None
                 ) -> bool:
    """Whether ``make_chunk_runner(cfg, n, graphs)`` runs the compiled chunk
    for a state on ``device``: the packed scan, on a CUDA device unless
    ``graphs`` is False, and on any device if it is True (where a CPU
    device raises)."""
    if not takes_packed_scan(cfg) or graphs is False:
        return False
    return bool(graphs) or torch.device(device).type == "cuda"


def make_chunk_runner(cfg: ModelConfig, n_steps: int,
                      graphs: bool | None = None):
    """``run(state, grid, forcing) -> state`` advancing ``n_steps``.

    * ``backend='pallas'`` on one device: the packed scan, Matsuno or
      RK4; it raises for what the kernels do not carry
      (``check_pallas``). On a CUDA device, and on a mesh too, it runs
      as the compiled chunk (``graphs.py``: captured steps, kept across
      chunks) unless
      ``graphs=False``, which runs the eager loop; ``graphs=True`` asks
      for the graphs on any device (a CPU device raises). A failed capture
      raises: nothing falls back to the eager loop by itself.
    * ``backend='pallas'`` on a mesh (``mesh_lat * mesh_lon > 1``): the
      sharded packed scan (``dist/packed_halo.py``, Matsuno only; RK4 is
      refused), whatever the sharding mode, as the reference's CLI takes
      it (``cli.py:181-192``). Its ``run`` takes and returns a ``dist.sharding.ShardedState``, or a
      global ``State`` that it splits and gathers around the run.
    * any other backend (``'jnp'``): the per-step path with the plain
      dynamics, on whatever device the state is on. On a mesh, as the
      reference's CLI takes it (``cli.py:181-197``): sharding mode
      ``shard_map`` takes the per-operator halo path
      (``dist/halo.py::make_sharded_step_fn``); ``auto`` across
      ``torch.distributed`` ranks the global program on DTensors
      (``dist/halo.py::make_auto_runner``), and ``auto`` in one process the
      global program on the mesh's one device. The first two take and
      return a ``ShardedState`` of ghost-free blocks, or a global ``State``
      that they split and gather around the run."""
    sh = cfg.sharding
    sharded = sh.mesh_lat * sh.mesh_lon > 1
    if not takes_packed_scan(cfg):
        if sharded and sh.mode == "shard_map":
            from .dist.halo import make_sharded_step_fn
            return make_sharded_step_fn(cfg, n_steps)
        if sharded and in_process_group():
            from .dist.halo import make_auto_runner
            return make_auto_runner(cfg, n_steps)
        step = make_step_fn(cfg)

        def run(state: State, grid: Grid, forcing: Forcing) -> State:
            return run_scan(step, state, grid, forcing, n_steps)

        return run

    check_pallas(cfg)
    if sharded:
        from .dist.packed_halo import make_packed_sharded_runner
        eager = make_packed_sharded_runner(cfg, n_steps)
    else:
        eager = _packed_runner(cfg, n_steps)
    from .dist.sharding import ShardedState
    from .graphs import make_graph_runner
    compiled = make_graph_runner(cfg, n_steps)

    def run(state, grid: Grid, forcing: Forcing = None):
        one = state.states[0] if isinstance(state, ShardedState) else state
        runner = compiled if takes_graphs(cfg, one.device, graphs) else eager
        return runner(state, grid, forcing)

    return run


def make_run_fn(cfg: ModelConfig, n_steps: int, donate: bool = True):
    """``run(state, grid, forcing) -> state`` advancing ``n_steps``: the
    chunk runner of ``make_chunk_runner``. ``donate`` is the reference's
    (it donates the state's buffers to the jitted run) and does nothing
    here: on the compiled chunk two sets of static buffers, ping-ponged,
    take donation's place, and the run copies the caller's state in and
    the result out, so the caller's state stays valid either way."""
    del donate
    return make_chunk_runner(cfg, n_steps)
