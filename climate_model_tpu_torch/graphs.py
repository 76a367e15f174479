"""The compiled chunk: the packed scan's step as CUDA graphs.

The port's counterpart of what ``jit`` does for the reference's chunk
programs: one compiled device program per chunk length, kept in
``programs`` (``climate_model_tpu/cli.py:183-209``), the state's buffers
donated (``climate_model_tpu/model.py:195-206``), ``dt`` and the
autoconversion fraction a runtime operand (``model.py:121-125``), and the
sharded programs jitted too (``dist/packed_halo.py:295``). Here:

* **State.** Two sets of static buffers of the prognostic fields,
  ping-ponged: a step reads one set and the corrector writes the other
  (the counterpart of donation). The radiation caches and ``t`` have one
  buffer each, written in place. A run copies the caller's state in and
  the result out, so the caller's state stays valid.
* **Graphs.** One ``torch.cuda.CUDAGraph`` per (buffer parity, radiation
  refresh or not), warmed up on a side stream and captured there, from one
  private memory pool. A graph holds one call of the packed-scan step
  (``model.py``: ``PackedStep`` on one device, ``dist/packed_halo.py::
  ShardStep`` on a mesh, both built with ``static=True``), then ``t +=
  dt`` on every block from the device scalar. A Matsuno step is radiation
  on its interval, the predictor and the corrector with the epilogue; an
  RK4 step (one device) the four stages and the epilogue in its place,
  with buffers of its own that the step holds (``model.packed_work``: two
  stage states, written in turns, and the accumulator), beside the two
  sets that hold the t_n state and the result. One class, ``_Captured``,
  runs either step.
* **Replay.** By the host step counter, so the radiation cadence stays
  ``step % rad_every_steps``; a chunk is a count of replays. A new ``dt``
  is a write into the scalar buffer (``kernels/fused_substep.py::
  StepScalars``), never a re-capture.
* **Cache.** The captures are kept across chunks, keyed on the config, the
  shapes, the device and the layout, and on the grid, forcing and exchange
  objects the capture read (the counterpart of ``cli.py``'s ``programs``):
  a run's chunks replay the same graphs.
* **Host work at capture.** Validation, ``launch_plan``, the geometry
  tables and the output allocations happen once, at capture; a replay is
  one ``cudaGraphLaunch``.
* **Counters** (``trace.py``). A replay runs no Python: each capture
  keeps what it counted, the difference of two ``counts()``, and every
  replay adds it (``add_counts``), so every count that a run checks stays
  true.
* **Spans** (``trace.py``): ``cm.capture`` around a runner's warm-up and
  captures, ``cm.step.radiation`` around each replay of a step that
  refreshes the radiation. None is opened inside a captured step.

On a mesh in one process, one graph holds every shard's step: the
launches, the ``LocalExchange`` slice copies and the seam strips' cuts and
splices, in the eager order. Across ranks the
``DistExchange`` packs into and unpacks from buffers allocated once
(``use_static_buffers``) and its ``batch_isend_irecv`` posts are captured
in the step's graph under NCCL, in the eager posting order; the warm-up
before the capture makes each peer pair's first exchange.

There is no fallback: a failed capture or replay raises, and the eager
loop runs only where the caller asks for it (``model.make_chunk_runner(...,
graphs=False)``) or on the CPU, which has no graphs. The tests run the
runners' bookkeeping on the CPU with a stand-in for the capture.
"""

from __future__ import annotations

import collections
import time

import torch

from .core.config import ModelConfig, check_rad_resolved
from .core.grid import Grid
from .core.state import Forcing, State
from .dist.packed_halo import PROG_FIELDS, RAD_FIELDS, ShardStep, check_blocks
from .dist.sharding import Halo, ShardedState, global_io
from .dycore.stepper import check_pallas
from .kernels.fused_substep import StepScalars, autoconv_tau
from .model import PackedStep, phys_epilogue_tuple
from .physics.radiation import radiation_refresh, refresh_due
from .trace import add_counts, counts, reset_counts, span

CACHE_SIZE = 4          # runners kept, least recently used first out

captures = 0            # graphs captured by this process


class CudaCapture:
    """Captures callables as CUDA graphs on a side stream of ``device``,
    all from one private memory pool."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise RuntimeError(
                f"CUDA graphs need a CUDA device, not {device}; the CPU "
                "runs the eager loop (make_chunk_runner(..., graphs=False))")
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm(self, fn):
        """``fn`` run eagerly on the side stream, as a capture needs first."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)

    def __call__(self, fn) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            fn()
        return graph

    def pool_bytes(self):
        """Bytes the pool holds on the device (its segments), or None where
        the allocator's snapshot does not name the pool."""
        segs = torch.cuda.memory_snapshot()
        if not segs or "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))


def _refresh_kinds(cfg: ModelConfig) -> tuple:
    if not cfg.physics.radiation:
        return (False,)
    return (True,) if max(cfg.physics.rad_every_steps, 1) == 1 \
        else (False, True)


def _refresh(cfg: ModelConfig, step: int) -> bool:
    return cfg.physics.radiation and refresh_due(step, cfg)


def _buffers(state: State) -> tuple:
    """Two sets of the prognostic fields, the radiation caches and t, all
    shaped as ``state``'s."""
    sets = [{f: torch.empty_like(getattr(state, f)) for f in PROG_FIELDS}
            for _ in range(2)]
    rad = {f: torch.empty_like(getattr(state, f)) for f in RAD_FIELDS}
    return sets, rad, torch.empty_like(state.t)


class _Captured:
    """The captured steps of one runner: ``step_fn = make_step()``, a
    packed-scan step built with ``static=True`` on the blocks ``states``
    (one on one device), as one graph a (parity, refresh) key, and what
    each capture counted. Per block two buffer sets
    (``sets[parity][block]``), the radiation caches and ``t``; one
    ``StepScalars`` for every block. The step is built after the buffers,
    so that its own (RK4's stage states) lie after them on the device."""

    def __init__(self, cfg: ModelConfig, make_step, states: list,
                 dt: float, capture):
        self.cfg, self.capture = cfg, capture
        self.keys = [(p, r) for p in (0, 1) for r in _refresh_kinds(cfg)]
        self.graphs, self.deltas = {}, {}
        self.capture_s = 0.0
        self.pool_bytes = None
        bufs = [_buffers(s) for s in states]
        self.sets = [[b[0][p] for b in bufs] for p in (0, 1)]
        self.rad = [b[1] for b in bufs]
        self.t = [b[2] for b in bufs]
        self.scalars = StepScalars(states[0].device,
                                   autoconv_tau(phys_epilogue_tuple(cfg)))
        self.scalars.set(dt)
        self.step_fn = make_step()
        self._load(states)
        self._build()

    def _load(self, states: list):
        for s, fields, rad, t in zip(states, self.sets[0], self.rad, self.t):
            for f, x in list(fields.items()) + list(rad.items()):
                x.copy_(getattr(s, f))
            t.copy_(s.t)

    def step(self, parity: int, refresh: bool):
        """One step from set ``parity`` into the other (what is captured)."""
        states = [State(**fields, **rad, t=t, step=0) for fields, rad, t
                  in zip(self.sets[parity], self.rad, self.t)]
        fn = self.step_fn

        def radiation(i: int, s: State) -> State:
            if refresh:
                new = radiation_refresh(s, fn.grids[i], fn.forcings[i],
                                        self.cfg)
                for f in RAD_FIELDS:
                    self.rad[i][f].copy_(getattr(new, f))
            return s

        fn(states, radiation, scalars=self.scalars,
           outs=self.sets[1 - parity])
        for t in self.t:
            self.scalars.advance(t)

    def _build(self):
        """Warm every variant of ``step(parity, refresh)``, then capture
        each (the span ``cm.capture``); the counters are left as they
        were."""
        global captures
        with span("capture"):
            before = counts()
            for key in self.keys:
                self.capture.warm(lambda k=key: self.step(*k))
            t0 = time.perf_counter()
            for key in self.keys:
                at = counts()
                self.graphs[key] = self.capture(lambda k=key: self.step(*k))
                self.deltas[key] = counts() - at
                captures += 1
            reset_counts(before)
            self.capture_s = time.perf_counter() - t0
        self.pool_bytes = self.capture.pool_bytes()

    def replay(self, key):
        """Replay the step ``key``; one that refreshes the radiation under
        the span ``cm.step.radiation``, a plain one under none. The
        counters move by what its capture counted."""
        if key[1]:
            with span("step.radiation"):
                self.graphs[key].replay()
        else:
            self.graphs[key].replay()
        add_counts(self.deltas[key])

    def run(self, states: list, dt: float, n: int) -> list:
        """``n`` steps from the blocks ``states``: the blocks after them,
        copies of the buffers the last step wrote."""
        self.scalars.set(dt)
        self._load(states)
        step0 = states[0].step
        for i in range(n):
            self.replay((i % 2, _refresh(self.cfg, step0 + i)))
        return [State(**{f: x.clone() for f, x in fields.items()},
                      **{f: x.clone() for f, x in rad.items()},
                      t=t.clone(), step=step0 + n)
                for fields, rad, t in zip(self.sets[n % 2], self.rad,
                                          self.t)]


def describe(mesh=None) -> str:
    """The compiled chunk, for a run's start line."""
    where = ""
    if mesh is not None and mesh.distributed:
        where = (", NCCL posts captured in the step's graph (exchange "
                 "buffers allocated once)")
    elif mesh is not None:
        where = ", every shard's step and exchange in one graph"
    return ("compiled chunk (CUDA graphs: a step per buffer parity and "
            f"radiation variant, dt a device operand{where})")


_cache = collections.OrderedDict()


def _ids(*objs) -> tuple:
    """Identities of the tensors of dataclasses ``objs`` (a cache entry
    keeps them alive, so no other tensor takes one while it is cached)."""
    return tuple(id(getattr(o, f)) for o in objs
                 for f in o.__dataclass_fields__
                 if isinstance(getattr(o, f), torch.Tensor))


def _cached(key, make):
    runner = _cache.get(key)
    if runner is None:
        runner = _cache[key] = make()
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
    _cache.move_to_end(key)
    return runner


def clear_cache():
    """Drop every cached runner (and with them their graphs and pools)."""
    _cache.clear()


def cached_runners() -> list:
    """The cached runners, least recently used first."""
    return list(_cache.values())


def make_graph_runner(cfg: ModelConfig, n_steps: int, capture=None):
    """``run(state, grid, forcing)`` advancing ``n_steps`` through the
    captured steps of ``cfg``'s packed scan: on one device for a ``State``,
    on the mesh of ``cfg`` for a ``ShardedState`` (or a global ``State``,
    split and gathered, as the eager runner does). ``capture(device)``
    makes the capturer (``CudaCapture``, which raises on a CPU device; the
    tests pass a stand-in). Runners are cached (``_cached``)."""
    check_rad_resolved(cfg)
    check_pallas(cfg)
    capture = capture or CudaCapture
    sh = cfg.sharding

    def sharded(ss: ShardedState, dt: float) -> _Captured:
        check_blocks(cfg, ss)
        ss.exchange.use_static_buffers()
        return _Captured(cfg, lambda: ShardStep(cfg, ss, dt, static=True),
                         ss.states, dt, capture(ss.states[0].device))

    def run_blocks(ss: ShardedState, dt: float) -> ShardedState:
        s0 = ss.states[0]
        key = ("sharded", cfg, ss.layouts, ss.halo, ss.mesh.n_lat,
               ss.mesh.n_lon, ss.mesh.rank, str(s0.device), s0.dtype,
               tuple(s0.u.shape), capture, id(ss.exchange),
               _ids(*ss.grids, *ss.forcings))
        runner = _cached(key, lambda: sharded(ss, dt))
        return ss.replace(states=tuple(runner.run(ss.states, dt, n_steps)))

    if sh.mesh_lat * sh.mesh_lon > 1:
        return global_io(cfg, run_blocks, Halo())

    def run(state: State, grid: Grid, forcing: Forcing) -> State:
        key = ("packed", cfg, str(state.device), state.dtype,
               tuple(state.u.shape), capture, _ids(grid, forcing))
        runner = _cached(key, lambda: _Captured(
            cfg, lambda: PackedStep(cfg, state, grid, forcing, static=True),
            [state], grid.dt, capture(state.device)))
        (out,) = runner.run([state], grid.dt, n_steps)
        return out

    return run

