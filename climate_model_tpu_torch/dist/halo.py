"""The plain backend on a device mesh: per-operator halos and GSPMD auto.

Port of ``climate_model_tpu/dist/halo.py::make_sharded_step_fn`` (``:29-49``)
and of the reference's GSPMD ``auto`` mode (``cli.py:181-197``,
``bench/scaling.py:53-67``).

**Per-operator halos** (``make_sharded_step_fn``, sharding mode
``shard_map``): the whole per-step model (``model.py::make_step_fn`` with
the plain dynamics, then ``run_scan``) runs once per shard on the shard's
ghost-free block (``dist/sharding.py``, ``Halo(0, 0, 0)``), inside
``dycore/boundaries.py``'s ``shard_mode``, where every neighbour shift of
the operators fetches its one-cell halo from the neighbouring shard
(``dist/comm.py``, ``Edges``). ``shard_map`` runs its shards in lockstep;
eager PyTorch in one process runs one after another, so there each shard
runs on a thread of its own, and the threads meet at every shift
(``LocalEdges``). Across ranks each rank runs its own shard and the shifts
are point-to-point messages (``DistEdges``). Matsuno, Euler and RK4 reach
their neighbours only through the shifts, so all three run here.

**GSPMD auto** (``make_auto_runner``): across ranks the global program
runs on DTensors (``dist/sharding.py``, ``to_dtensors``), which PyTorch
partitions: it redistributes data where an op needs it, which is not a halo
exchange. In one process PyTorch has no partitioner that runs several
shards, so ``model.py::make_chunk_runner`` runs the global program on the
mesh's one device, and the start line says so (``describe``).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.config import ModelConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..dycore import boundaries as bc
from ..dycore.stepper import dynamics_step_fn, run_scan
from . import sharding
from .comm import Aborted, make_edges
from .mesh import Mesh, validate_divisibility
from .sharding import Halo, ShardedState

NO_HALO = Halo(0, 0, 0)

_POOLS = {}
_POOLS_LOCK = threading.Lock()


def _pool(n: int) -> ThreadPoolExecutor:
    """``n`` worker threads, made once per process and kept (a run's chunks
    reuse them)."""
    with _POOLS_LOCK:
        if n not in _POOLS:
            _POOLS[n] = ThreadPoolExecutor(max_workers=n,
                                           thread_name_prefix="shard")
        return _POOLS[n]


def in_lockstep(edges, fn, jobs: list) -> list:
    """``fn(*args)`` for each ``(shard, args)`` of ``jobs``, every shard of
    ``edges.mesh`` on its own thread under ``bc.shard_mode``; the results
    in ``jobs`` order. The first failure of any thread is raised here, once
    every thread has stopped."""
    stream = None
    dev = next((a.device for _, args in jobs for a in args
                if isinstance(a, torch.Tensor)), None)
    if dev is not None and dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)   # the caller's, for all

    def work(shard, args):
        try:
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext(), \
                    bc.shard_mode(edges, shard):
                out = fn(*args)
            edges.finish(shard)
            return out
        except Aborted:
            return None
        except Exception as exc:
            edges.fail(exc)
            return None

    pool = _pool(len(jobs))
    outs = [f.result() for f in [pool.submit(work, shard, args)
                                 for shard, args in jobs]]
    if edges.error is not None:
        raise edges.error
    return outs


def _check(cfg: ModelConfig, ss: ShardedState):
    mesh = ss.mesh
    sh = cfg.sharding
    if (mesh.n_lat, mesh.n_lon) != (sh.mesh_lat, sh.mesh_lon):
        raise ValueError(f"blocks of a {mesh.n_lat}x{mesh.n_lon} mesh, "
                         f"config {sh.mesh_lat}x{sh.mesh_lon}")
    validate_divisibility(cfg, mesh)
    if ss.halo != NO_HALO:
        raise ValueError("the plain backend's mesh path runs on ghost-free "
                         f"blocks (Halo(0, 0, 0)), got {ss.halo}")


def make_sharded_step_fn(cfg: ModelConfig, n_steps: int = 1):
    """``run(state, grid, forcing)`` advancing ``n_steps`` of the plain
    per-step model on the mesh of ``cfg``, each shard inside
    ``bc.shard_mode`` (the module docstring). ``cfg.sharding.halo_overlap``
    does nothing here, as in the reference. Adds each run's shifts per
    shard to ``make_sharded_step_fn.shifts``, and in one process the
    seconds a shard's thread waited at the rendezvous (the mean over the
    shards) to ``make_sharded_step_fn.waited_s``."""
    from ..model import make_step_fn

    step = make_step_fn(cfg, dynamics=dynamics_step_fn(
        cfg.replace(backend="jnp")))

    def local_run(state: State, grid: Grid, forcing: Forcing) -> State:
        return run_scan(step, state, grid, forcing, n_steps)

    def run_blocks(ss: ShardedState, dt: float) -> ShardedState:
        _check(cfg, ss)
        edges = make_edges(ss.mesh)
        jobs = [(shard, (st, g.replace(dt=dt), fo))
                for shard, st, g, fo in zip(ss.mesh.local_shards, ss.states,
                                            ss.grids, ss.forcings)]
        if ss.mesh.distributed:
            ((shard, args),) = jobs
            with bc.shard_mode(edges, shard):
                outs = [local_run(*args)]
        else:
            outs = in_lockstep(edges, local_run, jobs)
            make_sharded_step_fn.waited_s += sum(edges.waited) / len(jobs)
        make_sharded_step_fn.shifts += edges.shifts[jobs[0][0]]
        return ss.replace(states=tuple(outs))

    return sharding.global_io(cfg, run_blocks, NO_HALO)


make_sharded_step_fn.shifts = 0
make_sharded_step_fn.waited_s = 0.0


def make_auto_runner(cfg: ModelConfig, n_steps: int = 1):
    """``run(state, grid, forcing)`` advancing ``n_steps`` of the plain
    per-step model across ranks in GSPMD ``auto`` mode: the global program
    on the DTensors of this rank's ghost-free block."""
    from ..model import make_step_fn

    step = make_step_fn(cfg, dynamics=dynamics_step_fn(
        cfg.replace(backend="jnp")))

    def run_blocks(ss: ShardedState, dt: float) -> ShardedState:
        _check(cfg, ss)
        if not ss.mesh.distributed:
            raise ValueError("GSPMD auto on blocks needs one shard per rank; "
                             "in one process it runs the global State")
        state, grid, forcing = sharding.to_dtensors(ss)
        out = run_scan(step, state, grid.replace(dt=dt), forcing, n_steps)
        return sharding.from_dtensors(ss, out)

    return sharding.global_io(cfg, run_blocks, NO_HALO)


def takes_blocks(cfg: ModelConfig, mesh: Mesh) -> bool:
    """Whether the plain backend's mesh runner of ``cfg`` takes blocks
    (``shard_map``, or ``auto`` across ranks) rather than the global State
    (``auto`` in one process)."""
    return cfg.sharding.mode == "shard_map" or mesh.distributed


def describe(cfg: ModelConfig, mesh: Mesh) -> str:
    """The plain backend's mesh path, for a start line or a metric."""
    sh = cfg.sharding
    where = f"mesh={sh.mesh_lat}x{sh.mesh_lon}"
    if sh.mode == "shard_map":
        note = ("; halo overlap does nothing on this path"
                if sh.halo_overlap else "")
        return (f"sharded per-step (plain PyTorch, per-operator halos)  "
                f"{where} (shard_map, {mesh.describe()}{note})")
    if mesh.distributed:
        return (f"GSPMD auto: the global program on DTensors  {where} "
                f"({mesh.describe()})")
    return (f"GSPMD auto: the global program on 1 device ({mesh.device}) "
            f"({mesh.size} shards share it)  {where}")
