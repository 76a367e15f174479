"""One run of one cell: set-up, the measured window through ``cli.run``, the
reading of the trace and the comparison with the plain reference.

A cell is ``workloads/<cell>.json`` (its configuration's name, chips and
traffic parameters) over ``configs/<config>.toml`` (the namelist as run,
with a ``[benchmark]`` table of its source and, where its step is not the
one ``reference/`` follows, the plain reference that judges it:
``reference_of``). The window drives the entry
users call, ``climate_model_tpu_torch.cli.run``, resumed through
``restart_from`` from the seeded state (``inputs.py``). The harness finds
the chunk runner that ``cli.run`` calls once a chunk by a wrapper of its own
around ``model.make_chunk_runner``; the port is not edited:

* runner call 0, the first chunk, captures the CUDA graphs and runs its
  steps: set-up, like the imports, the kernel build or load, the port's
  ``initialize``, the restart read and the graph capture;
* the window opens at runner call 1, once the device has finished call 0's
  work, and closes when ``cli.run`` returns, after its final synchronize
  (and, where the cell writes files, the final checkpoint);
* runner call ``c``, drawn from the seed, is the stretch the reference
  follows: its input and output are copied on the device as they pass.

Every run does the same work: the number of chunks follows from
``--seconds`` and the cell's ``nominal_chunk_s``, not from a measurement.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time
import tomllib
from types import ModuleType
from typing import NamedTuple

import torch

from . import check, inputs

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PORT = "climate_model_tpu_torch"
# top-level module names that may not be loaded in a run (compared whole:
# the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "climate_model_tpu")
# the reference of a configuration whose [benchmark] table names none
REFERENCE = "reference"


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload: its name, configuration (the TOML namelist as a dict,
    without its ``[benchmark]`` table), chips, traffic parameters, limits
    and the reference package that judges it."""

    name: str
    config: str
    chips: int
    namelist: dict
    traffic: dict
    limits: dict
    reference: str = REFERENCE


def load_cell(name: str) -> Cell:
    with open(os.path.join(BENCH, "workloads", f"{name}.json")) as f:
        wl = json.load(f)
    with open(os.path.join(BENCH, "configs", f"{wl['config']}.toml"),
              "rb") as f:
        nl = tomllib.load(f)
    table = nl.pop("benchmark", {})
    return Cell(name=name, config=wl["config"], chips=int(wl["chips"]),
                namelist=nl, traffic=wl["traffic"], limits=wl["limits"],
                reference=table.get("reference", REFERENCE))


class Reference(NamedTuple):
    """A plain reference package: its name (relative to ``benchmark/``) and
    the modules the harness reads of it."""

    name: str
    config: ModuleType      # config_from_dict
    grid: ModuleType        # make_grid
    init: ModuleType        # initial_state_np
    model: ModuleType       # STATE_FIELDS, reference_device, build,
    #                         make_state, step, chunk_dt


def reference_of(cell: Cell) -> Reference:
    """The plain reference that judges ``cell``: the package that its
    configuration's ``[benchmark] reference`` names, a dotted path relative
    to ``benchmark/`` (``reference`` where the key is absent). Raises where
    the package, or a module of the benchmark that it imports, imports
    ``jax``, the JAX package or anything of the port."""
    name = cell.reference
    if not re.fullmatch(r"[A-Za-z_]\w*(\.[A-Za-z_]\w*)*", name):
        raise ValueError(f"{cell.config}: reference {name!r} is no dotted "
                         f"package path relative to benchmark/")
    found = loaded_forbidden((), (name,))
    if found:
        raise ImportError(f"{cell.config}: the reference {name!r} imports "
                          f"{found}")
    pkg = f"{__package__}.{name}"
    return Reference(name, *(importlib.import_module(f"{pkg}.{m}")
                             for m in ("config", "grid", "init", "model")))


def loaded_forbidden(modules=None, references=()) -> list:
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded), and those, with the port, that a
    reference package in ``references`` imports (``reference_imports``)."""
    names = sys.modules if modules is None else modules
    found = {m.partition(".")[0] for m in names} & set(FORBIDDEN)
    for ref in references:
        found |= reference_imports(ref) & {*FORBIDDEN, PORT}
    return sorted(found)


def _imported(path: str, package: list) -> set:
    """The modules that the file ``path``, of the package ``package`` (its
    dotted name's parts), names in its import statements, absolute."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] \
                if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out |= {mod} | {f"{mod}.{a.name}" for a in node.names}
    return out


def _benchmark_file(mod: str):
    """The file of the benchmark's module ``mod`` (dotted), or None."""
    head, _, rest = mod.partition(".")
    if head != __package__ or not rest:
        return None
    base = os.path.join(BENCH, *rest.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(path):
            return path
    return None


def reference_imports(name: str) -> set:
    """The top-level names that the reference package ``name`` imports, read
    from the source: in each of its files and, in turn, in each module of
    the benchmark that one of them imports."""
    root = os.path.join(BENCH, *name.split("."))
    todo = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith(".py")]
    seen, names = set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        package = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
        for mod in _imported(path, package):
            names.add(mod.partition(".")[0])
            found = _benchmark_file(mod)
            if found:
                todo.append(found)
    return names


# ---------------------------------------------------------------------------
# The run's configuration: the namelist with the cell's traffic on top.
# ---------------------------------------------------------------------------

def chunk_steps(cell: Cell) -> tuple:
    """(steps a chunk, dt) at the configuration's initial dt in its working
    precision, as ``cli.run`` sizes its chunks."""
    ref = reference_of(cell)
    rcfg = ref.config.config_from_dict(cell.namelist)
    dt = float(ref.grid.make_grid(rcfg.grid, rcfg.numerics,
                                  dtype=getattr(torch, rcfg.dtype),
                                  device="cpu").dt)
    return max(int(cell.traffic["chunk_hours"] * 3600.0 / dt), 1), dt


def n_chunks(cell: Cell, seconds: float) -> int:
    """The window's chunks: as many as ``seconds`` holds at the cell's
    nominal pace, and at least one more than the traced ones."""
    tr = cell.traffic
    return max(int(round(seconds / tr["nominal_chunk_s"])),
               tr["trace_chunks"] + 1)


def run_namelist(cell: Cell, chunks: int) -> dict:
    """The namelist ``cli.run`` gets: the cell's chunk cadence, a horizon
    of call 0's chunk and ``chunks`` more, its mesh and schedule, and a
    checkpoint once a simulated day (written only where the cell has an
    ``out_dir``)."""
    tr = cell.traffic
    steps, dt = chunk_steps(cell)
    nl = json.loads(json.dumps(cell.namelist))
    nl["sim_days"] = (1 + chunks) * steps * dt / 86400.0
    nl["out_every_hours"] = tr["chunk_hours"]
    nl["restart_every_days"] = 1.0
    lat, lon = tr["mesh"]
    nl["sharding"] = dict(mesh_lat=lat, mesh_lon=lon, mode="shard_map",
                          halo_overlap=bool(tr.get("halo_overlap", False)))
    return nl


# ---------------------------------------------------------------------------
# The window: a wrapper around the chunk runner.
# ---------------------------------------------------------------------------

def _is_sharded(state) -> bool:
    return hasattr(state, "layouts") and hasattr(state, "states")


def snapshot(state, fields: tuple) -> dict:
    """A copy on the device of ``state``'s ``fields`` (for a sharded state,
    this rank's interior block), with ``t``, ``step`` and, for a block, its
    place in the global grid."""
    if _is_sharded(state):
        (st,), (lay,) = state.states, state.layouts
        copies = {f: getattr(st, f)[..., lay.rows, lay.cols].clone()
                  for f in fields}
        where = (lay.lat_idx, lay.lon_idx)
    else:
        st = state
        copies = {f: getattr(st, f).clone() for f in fields}
        where = None
    return dict(fields=copies, t=st.t.clone(), step=int(st.step),
                where=where)


class Window:
    """Wraps ``make_chunk_runner``: opens the window at runner call 1,
    copies the input of call 0 and the input and output of call
    ``compare`` (their ``fields``), keeps each call's steps and dt, and
    drives the tracer."""

    def __init__(self, compare: int, device: torch.device, fields: tuple,
                 tracer=None, trace_chunks: int = 0,
                 distributed: bool = False):
        self.compare = compare
        self.fields = fields
        self.device = device
        self.cuda = device.type == "cuda"
        self.tracer = tracer
        self.trace_chunks = trace_chunks
        self.distributed = distributed
        self.calls = []             # per runner call: its steps and dt
        self.snaps = {}
        self.t_open = self.wall_open = None
        self.wall_call0 = self.wall_call0_end = None
        self.peaks = []             # the program's peaks between copies
        self.held = 0               # device bytes the copies hold

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _copy(self, key, state):
        """Copy ``state`` aside; the program's peak memory leaves the copy
        out (``peak_bytes``)."""
        if self.cuda:
            self.peaks.append(torch.cuda.max_memory_allocated(self.device)
                              - self.held)
            before = torch.cuda.memory_allocated(self.device)
        self.snaps[key] = snapshot(state, self.fields)
        if self.cuda:
            self.held += torch.cuda.memory_allocated(self.device) - before
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if not self.cuda:
            return 0
        now = torch.cuda.max_memory_allocated(self.device) - self.held
        return int(max(self.peaks + [now]))

    def wrap(self, make):
        def make_chunk_runner(cfg, n_steps, graphs=None):
            runner = make(cfg, n_steps, graphs)

            def run(state, grid, forcing=None):
                i = len(self.calls)
                if i == 1:
                    self._sync()
                    if self.distributed:
                        import torch.distributed as tdist
                        tdist.barrier()
                    self.t_open = time.perf_counter()
                    self.wall_open = time.time()
                tr = self.tracer
                if tr is not None and i == 1:
                    tr.start()
                if tr is not None and i == 1 + self.trace_chunks:
                    with torch.profiler.record_function("bench.trace_end"):
                        pass
                    tr.stop()
                if i == 0:
                    self.wall_call0 = time.time()
                    self._copy("start", state)
                if i == self.compare:
                    self._copy("in", state)
                with torch.profiler.record_function("bench.runner"):
                    out = runner(state, grid, forcing)
                if i == self.compare:
                    self._copy("out", out)
                self.calls.append(dict(n=int(n_steps), dt=float(grid.dt)))
                if i == 0:
                    self._sync()
                    self.wall_call0_end = time.time()
                if tr is not None and i == 0:
                    tr.prepare()
                return out

            return run

        return make_chunk_runner


@contextlib.contextmanager
def patched(window: Window):
    """The port's chunk runner wrapped by ``window``, and the harness's spans
    around the diagnostics, the NetCDF writes and the checkpoints; restored
    on exit."""
    model = importlib.import_module(f"{PORT}.model")
    metrics = importlib.import_module(f"{PORT}.io.metrics")
    netcdf = importlib.import_module(f"{PORT}.io.netcdf")
    ckpt = importlib.import_module(f"{PORT}.io.checkpoint")
    saved = (model.make_chunk_runner, metrics.diagnostics, netcdf.NCWriter,
             ckpt.save_checkpoint)
    make, diag, writer, save = saved

    def spanned(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    class NCWriter(writer):
        write = spanned("bench.nc_write", writer.write)

    model.make_chunk_runner = window.wrap(make)
    metrics.diagnostics = spanned("bench.diagnostics", diag)
    netcdf.NCWriter = NCWriter
    ckpt.save_checkpoint = spanned("bench.checkpoint", save)
    try:
        yield
    finally:
        (model.make_chunk_runner, metrics.diagnostics, netcdf.NCWriter,
         ckpt.save_checkpoint) = saved


# ---------------------------------------------------------------------------
# Gathering a sharded run's readings on rank 0.
# ---------------------------------------------------------------------------

def global_snapshot(snap: dict, distributed: bool) -> dict:
    """A snapshot's global fields on rank 0 (None on the other ranks): a
    single device's as they are, a block's gathered from every rank."""
    if not distributed:
        return snap
    import torch.distributed as tdist
    rank, world = tdist.get_rank(), tdist.get_world_size()
    wheres = [None] * world
    tdist.all_gather_object(wheres, snap["where"])
    n_lat = 1 + max(w[0] for w in wheres)
    n_lon = 1 + max(w[1] for w in wheres)
    out = {}
    for f, x in snap["fields"].items():
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)] \
            if rank == 0 else None
        tdist.gather(x, parts, dst=0)
        if rank == 0:
            grid = [[None] * n_lon for _ in range(n_lat)]
            for (a, b), p in zip(wheres, parts):
                grid[a][b] = p
            out[f] = torch.cat([torch.cat(row, dim=-1) for row in grid],
                               dim=-2).contiguous()
    if rank != 0:
        return None
    return dict(fields=out, t=snap["t"], step=snap["step"], where=None)


def to_host(snap: dict) -> dict:
    return dict(fields={f: x.cpu() for f, x in snap["fields"].items()},
                t=snap["t"].cpu(), step=snap["step"])


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------

def _gather_objects(obj, distributed: bool) -> list:
    if not distributed:
        return [obj]
    import torch.distributed as tdist
    out = [None] * tdist.get_world_size() if tdist.get_rank() == 0 else None
    tdist.gather_object(obj, out, dst=0)
    return out


def _readback(out_dir: str, state, fields: tuple) -> dict:
    """The last NetCDF snapshot and the checkpoint, read back from disk,
    against the state ``cli.run`` returned: the largest difference of any
    field each holds (both exact copies of the state's float32 values)."""
    import glob

    import numpy as np
    from scipy.io import netcdf_file
    host = {f: getattr(state, f).detach().cpu().numpy() for f in fields}
    nc_names = dict(UWIND="u", VWIND="v", POTT="pott", QV="qv", QC="qc",
                    COLP="colp", RAIN="rain", TSURF="tsurf",
                    SOILMOIST="soil_moist")
    files = sorted(glob.glob(os.path.join(out_dir, "out_*.nc")))
    nc_err = math.inf
    if files:
        with netcdf_file(files[-1], "r", mmap=False) as f:
            nc_err = max(float(np.max(np.abs(
                np.asarray(f.variables[k][0], np.float64) - host[v])))
                for k, v in nc_names.items())
            t_file = float(f.variables["time"][0])
        nc_err = max(nc_err, abs(t_file - float(np.float32(
            float(state.t) / 86400.0))))
    ck_err = math.inf
    path = os.path.join(out_dir, "restart.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            ck_err = max(float(np.max(np.abs(
                z[f].astype(np.float64) - host[f]))) for f in fields)
            ck_err = max(ck_err, abs(float(z["t"]) - float(state.t)),
                         abs(int(z["step"]) - int(state.step)))
    return dict(nc_snapshot=nc_err, checkpoint=ck_err)


def _free_program():
    importlib.import_module(f"{PORT}.graphs").clear_cache()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None) -> dict | None:
    """Run ``cell`` once; the result's fields on rank 0 (None on the other
    ranks). ``device`` 'cpu' runs the port's eager loop and the kernels'
    plain versions (tests); every device number is then left out."""
    t_start = time.time() if t_start is None else t_start
    cli = importlib.import_module(f"{PORT}.cli")
    cfg_port = importlib.import_module(f"{PORT}.core.namelist")
    ref = reference_of(cell)
    chunks = n_chunks(cell, seconds)
    nl = run_namelist(cell, chunks)
    pcfg = cfg_port.config_from_dict(json.loads(json.dumps(nl)))
    rcfg = ref.config.config_from_dict(json.loads(json.dumps(nl)))
    distributed = cell.chips > 1
    compare = inputs.compared_chunk(seed, chunks)
    if distributed:
        ctx = cli.multihost(device)
    else:
        ctx = contextlib.nullcontext(torch.device(device))
    tr = cell.traffic
    with ctx as dev:
        dev = torch.device(dev)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        rank = 0
        if distributed:
            import torch.distributed as tdist
            rank = tdist.get_rank()
        work = None
        arrays = None
        t_inputs = time.time()
        if rank == 0:
            base = os.environ.get("TMPDIR") or tempfile.gettempdir()
            work = tempfile.mkdtemp(prefix=f"bench-{cell.name}-", dir=base)
            arrays = inputs.seeded_state(ref, rcfg, seed)
            conv = importlib.import_module(f"{PORT}.io.convert")
            ckmod = importlib.import_module(f"{PORT}.io.checkpoint")
            st0 = conv.state_from_numpy(arrays, device="cpu",
                                        dtype=getattr(torch, pcfg.dtype))
            ckmod.save_checkpoint(os.path.join(work, "seed.npz"), st0, pcfg)
            del st0
        t_seeded = time.time()
        if distributed:
            holder = [work]
            tdist.broadcast_object_list(holder, src=0)
            work = holder[0]
        try:
            return _run(cell, seed, trace, dev, t_start, cli, pcfg, ref,
                        rcfg, chunks, compare, distributed, rank, work,
                        arrays, (t_inputs, t_seeded))
        finally:
            if rank == 0 and work:
                shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, trace, dev, t_start, cli, pcfg, ref, rcfg, chunks,
         compare, distributed, rank, work, arrays, marks):
    from . import trace as tracing
    tr = cell.traffic
    cuda = dev.type == "cuda"
    tracer = tracing.Tracer(cuda) if trace else None
    fields = ref.model.STATE_FIELDS
    window = Window(compare, dev, fields, tracer, tr["trace_chunks"],
                    distributed)
    out_dir = os.path.join(work, "out") if tr.get("out_dir") else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with patched(window):
        result = cli.run(pcfg, device=dev, out_dir=out_dir,
                         restart_from=os.path.join(work, "seed.npz"))
    t_close = time.perf_counter()
    wall = t_close - window.t_open
    if tracer is not None and tracer.events is None:
        tracer.stop()
    forbidden = loaded_forbidden(references=(ref.name,))
    peak = window.peak_bytes()
    calls = window.calls
    own = dict(rank=rank, peak=peak, calls=calls, forbidden=forbidden,
               trace=None)
    if tracer is not None:
        own["trace"] = tracing.records(tracer.events, rank)
    ranks = _gather_objects(own, distributed)
    snaps = {k: global_snapshot(window.snaps[k], distributed)
             for k in ("start", "in", "out")}
    readback = None
    if rank == 0 and out_dir:
        readback = _readback(out_dir, result.state, fields)
    aborted = result.aborted
    del result
    _free_program()
    if rank != 0:
        return None
    snaps = {k: to_host(s) for k, s in snaps.items()}
    torch.cuda.empty_cache() if cuda else None
    gc = pcfg.grid
    window_calls = calls[1:]
    steps = sum(c["n"] for c in window_calls)
    sim_s = sum(c["n"] * c["dt"] for c in window_calls)
    points = gc.nx * gc.ny * gc.nz
    t_ref = time.perf_counter()
    readings = check.follow(ref, rcfg, snaps, arrays, calls[compare], dev)
    ref_s = time.perf_counter() - t_ref
    if readback is not None:
        readings.update(readback)
    correct, lines = check.judge(readings, cell.limits)
    info = dict(
        wall_s=wall, steps=steps, sim_s=sim_s, points=points,
        setup_s=window.wall_open - t_start, chips=cell.chips,
        peak_bytes=max(r["peak"] for r in ranks), ranks=ranks,
        forbidden=sorted({m for r in ranks for m in r["forbidden"]}),
        chunks=len(window_calls), compare=compare, grid=(gc.nx, gc.ny, gc.nz),
        rad_every_steps=pcfg.physics.rad_every_steps, reference_s=ref_s,
        dtype=rcfg.dtype, reference=ref.name,
        setup_parts=dict(
            imports=marks[0] - t_start, seeded_restart=marks[1] - marks[0],
            to_first_chunk=window.wall_call0 - marks[1],
            first_chunk=window.wall_call0_end - window.wall_call0,
            to_window=window.wall_open - window.wall_call0_end))
    return dict(correct=bool(correct and not aborted),
                attempted=len(window_calls), failed=int(aborted), info=info,
                checks=lines, readings=readings)
