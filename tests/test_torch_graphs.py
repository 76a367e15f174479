"""The compiled chunk (``climate_model_tpu_torch/graphs.py``) on the CPU.

The CPU has no CUDA graphs, so the runners' bookkeeping runs under a
stand-in for the capture: ``StandInCapture`` records the captured callable
and calls it once at capture (Python runs while a real capture records)
and once on every replay, as a ``torch.cuda.CUDAGraph`` replays what was
captured, with the port's counters (``trace.py``) put back after it, as a
replay runs no Python. Against the eager runner (``make_chunk_runner(...,
graphs=False)``), at #3 cut to 32x16x8 in fp64 with radiation every 7
steps and chunks of 7, 5 and 12 steps, the last at another dt:

* the runner equals the eager runner bit for bit, on one device, on 2x2
  in one process (``LocalExchange``, both schedules) and across two gloo
  ranks (``DistExchange`` with its static buffers);
* the launch and refresh counts equal the eager runner's, each replay
  moves every counter by what its capture counted, the buffers ping-pong,
  no dt change makes a new capture, and the caller's state is left as it
  was;
* two planted faults break it: replays that keep the capture-time dt, and
  the same parity replayed twice;
* the kernels' ``(dt, frac)`` operand holds ``float32(dt)`` and
  ``_autoconv_frac``'s bits; the static exchange buffers carry what the
  eager ``cat`` and unpacking carry, bit for bit;
* the slice as a whole: the runner against the JAX package's packed scan.

The tests marked ``gpu`` capture on the card: a capture equal to the eager
runner, and a capture with a host sync inside it, which raises.
"""

import dataclasses
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest

FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
          "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc", "t")
CHUNKS = (7, 5, 12)              # steps; the last chunk at DT_SCALE * dt
DT_SCALE = 0.8
TIMEOUT_S = 120                  # the gloo ranks' join


class StandInGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        from climate_model_tpu_torch import trace
        saved = trace.counts()
        self.fn()
        trace.reset_counts(saved)


class StandInCapture:
    """What ``graphs.CudaCapture`` offers, on the CPU."""

    def __init__(self, device):
        self.device = device

    def warm(self, fn):
        fn()

    def __call__(self, fn):
        fn()
        return StandInGraph(fn)

    def pool_bytes(self):
        return None


def small_cfg(mesh=(1, 1), overlap=False):
    from climate_model_tpu_torch.core import config as tcfg
    b3 = tcfg.baseline_config(3)
    return b3.replace(
        grid=dataclasses.replace(b3.grid, nx=32, ny=16, nz=8),
        physics=dataclasses.replace(b3.physics, rad_every_steps=7,
                                    rad_every_hours=0.0),
        dtype="float64",
        sharding=dataclasses.replace(b3.sharding, mesh_lat=mesh[0],
                                     mesh_lon=mesh[1], mode="shard_map",
                                     halo_overlap=overlap))


def run_chunks(runner_for, state, grid, forcing, split=None):
    """``state`` through CHUNKS, a runner of each length; ``split(s)`` makes
    the blocks the runners take and the chunks' results are gathered."""
    from climate_model_tpu_torch.dist import sharding
    s = split(state) if split else state
    g = grid
    for i, n in enumerate(CHUNKS):
        g = grid.replace(dt=grid.dt * (DT_SCALE if i == 2 else 1.0))
        s = runner_for(n)(s, g, forcing)
    return sharding.gather(s) if split else s


def same(a, b) -> dict:
    import torch
    return {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
            for f in FIELDS}


def counting(monkeypatch, *modules):
    """Count the wrappers' calls on the CPU as on the card: each call moves
    the counter its launch would move (``fused_substep._count``)."""
    from climate_model_tpu_torch.kernels import fused_substep as fs

    def spy(fn):
        def call(*a, part="grid", **k):
            fs._count(fn.__name__, part, k.get("vmask") is not None,
                      epilogue=k.get("phys") is not None)
            return fn(*a, part=part, **k)
        return call

    for mod in modules:
        for name in ("predictor", "corrector"):
            monkeypatch.setattr(mod, name, spy(getattr(fs, name)))


def counts() -> dict:
    """The port's counters (``trace.py``), by name."""
    from climate_model_tpu_torch import trace
    return trace.counts()


def launched(c) -> dict:
    """The launch and refresh counts of ``c`` that are not 0: every counter
    but the plain physics splits' calls (which the kernels' plain versions
    make on the CPU)."""
    return {k: v for k, v in c.items() if v and not k.endswith(".calls")}


def reset():
    from climate_model_tpu_torch import trace
    trace.reset_counts()


def both(monkeypatch, cfg, split=None):
    """The eager and the stand-in runs of CHUNKS from ``cfg``'s initial
    state (``split(state, grid, forcing)``: the blocks the runners take),
    each with its counts and the captures it made."""
    from climate_model_tpu_torch import graphs, model
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist import packed_halo
    counting(monkeypatch, model, packed_halo)
    s, f, g = initialize(cfg, device="cpu")
    out = {}
    for name, runner_for in (
            ("eager", lambda n: model.make_chunk_runner(cfg, n,
                                                        graphs=False)),
            ("graphs", lambda n: graphs.make_graph_runner(
                cfg, n, capture=StandInCapture))):
        reset()
        c0 = graphs.captures
        res = run_chunks(runner_for, s, g, f,
                         split and (lambda st: split(st, g, f)))
        out[name] = (res, counts(), graphs.captures - c0)
    return s, out


@pytest.fixture(autouse=True)
def fresh_cache():
    """No runner cached across tests; the process-wide counters (which
    ``counting`` moves on the CPU) put back as they were."""
    from climate_model_tpu_torch import graphs, trace
    graphs.clear_cache()
    saved = trace.counts()
    yield
    trace.reset_counts(saved)
    graphs.clear_cache()


from ._torch_threads import torch_threads  # noqa: E402,F401 (fixture)


# ---------------------------------------------------------------------------
# The runtime scalars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt,tau", [(34.148, 1000.0), (247.8, 1000.0),
                                    (600.0, None)],
                         ids=["b3-dt", "gate-dt", "no-microphysics"])
def test_scalar_buffer_bits(dt, tau):
    import torch

    from climate_model_tpu_torch.kernels import fused_substep as fs
    sc = fs.StepScalars("cpu", tau)
    assert sc.set(dt) and not sc.set(dt)
    want = np.array([dt, 0.0 if tau is None else fs._autoconv_frac(dt, tau)],
                    dtype=np.float32)
    assert sc.buf.dtype == torch.float32
    assert sc.buf.numpy().view(np.uint32).tolist() == \
        want.view(np.uint32).tolist()
    assert sc.dt == dt
    t = torch.tensor(100.0, dtype=torch.float64)
    sc.advance(t)
    assert float(t) == 100.0 + dt           # the host dt on the CPU


def test_eager_launch_needs_no_scalars_but_a_capture_does(monkeypatch):
    """The eager path's operand is cached per value; a launch under a
    capture without its StepScalars raises rather than cache a buffer
    that holds no value."""
    import torch

    from climate_model_tpu_torch.kernels import fused_substep as fs
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="StepScalars"):
        fs._scalars_ptr(torch.device("cpu"), 30.0, None, None)
    sc = fs.StepScalars("cpu", None)
    assert fs._scalars_ptr(torch.device("cpu"), 30.0, None, sc) == \
        sc.buf.data_ptr()


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------

def test_one_device_equals_eager(monkeypatch):
    import torch

    from climate_model_tpu_torch import graphs
    cfg = small_cfg()
    s, out = both(monkeypatch, cfg)
    (a, ca, _), (b, cb, caps) = out["eager"], out["graphs"]
    assert a.step == b.step == sum(CHUNKS)
    assert all(same(a, b).values()), same(a, b)
    # a masked predictor and an epilogue corrector a step, radiation at
    # steps 0, 7, 14 and 21
    assert ca == cb
    n = sum(CHUNKS)
    assert launched(cb) == {
        "predictor.masked": n, "corrector.epilogue": n,
        "radiation.refreshes": 4}
    # one capture per (parity, refresh), none after the dt change
    assert caps == 4
    (runner,) = graphs.cached_runners()
    assert sorted(runner.graphs) == [(0, False), (0, True), (1, False),
                                     (1, True)]
    # the result is a copy of the set the last step wrote (24 steps: set 0)
    assert torch.equal(runner.sets[0][0]["u"], b.u)
    assert runner.sets[0][0]["u"].data_ptr() != b.u.data_ptr()
    # the caller's state is left as it was
    s2 = small_state(cfg)
    assert all(same(s, s2).values())


def small_state(cfg):
    from climate_model_tpu_torch.core.init import initialize
    return initialize(cfg, device="cpu")[0]


@pytest.mark.parametrize("n", [7, 12], ids=["odd", "even"])
def test_chunk_counts_and_parity(monkeypatch, n):
    """A chunk ends in the set of its parity; each replay moves every
    counter by what its capture counted, the plain physics splits' calls
    (which the compiled chunk names nowhere) too, and the captures move
    none."""
    import collections

    import torch

    from climate_model_tpu_torch import graphs, model, trace
    from climate_model_tpu_torch.core.init import initialize
    counting(monkeypatch, model)
    moved = []
    real = graphs._Captured.replay

    def replay(self, key):
        before = trace.counts()
        real(self, key)
        moved.append((self.deltas[key], trace.counts() - before))

    monkeypatch.setattr(graphs._Captured, "replay", replay)
    cfg = small_cfg()
    s, f, g = initialize(cfg, device="cpu")
    reset()
    out = graphs.make_graph_runner(cfg, n, capture=StandInCapture)(s, g, f)
    (runner,) = graphs.cached_runners()
    assert torch.equal(runner.sets[n % 2][0]["pott"], out.pott)
    c = counts()
    assert c["predictor.masked"] == n
    assert c["radiation.refreshes"] == len(range(0, n, 7))   # steps 0, 7
    assert runner.deltas[(0, True)]["radiation.refreshes"] == 1
    assert runner.deltas[(1, False)]["radiation.refreshes"] == 0
    assert all(d["surface.calls"] == 1 for d in runner.deltas.values())
    assert len(moved) == n and all(want == got for want, got in moved)
    assert c == sum((got for _, got in moved), collections.Counter())


def test_cpu_default_is_eager_and_graphs_true_raises():
    """On the CPU ``make_chunk_runner`` runs the eager loop unless asked
    for graphs, which need a card: nothing falls back."""
    from climate_model_tpu_torch import graphs, model
    from climate_model_tpu_torch.core.init import initialize
    cfg = small_cfg()
    s, f, g = initialize(cfg, device="cpu")
    c0 = graphs.captures
    model.make_chunk_runner(cfg, 2)(s, g, f)
    assert graphs.captures == c0 and not graphs.cached_runners()
    with pytest.raises(RuntimeError, match="CUDA graphs need a CUDA"):
        model.make_chunk_runner(cfg, 2, graphs=True)(s, g, f)


@pytest.mark.parametrize("fault", ["capture-time dt", "same parity twice"])
def test_planted_faults_break(monkeypatch, fault):
    from climate_model_tpu_torch import graphs
    from climate_model_tpu_torch.kernels import fused_substep as fs
    if fault == "capture-time dt":
        real = fs.StepScalars.set

        def first_only(self, dt):
            return real(self, dt) if self.dt is None else False
        monkeypatch.setattr(fs.StepScalars, "set", first_only)
    else:
        real = graphs._Captured.replay
        monkeypatch.setattr(graphs._Captured, "replay",
                            lambda self, key: real(self, (0, key[1])))
    _, out = both(monkeypatch, small_cfg())
    assert not all(same(out["eager"][0], out["graphs"][0]).values())


def test_one_device_matches_reference(monkeypatch):
    """The slice as a whole: the compiled chunk (stand-in) against the JAX
    package's packed scan over 12 steps, at the bounds of
    ``test_torch_model.py``."""
    from climate_model_tpu import model as jmodel
    from climate_model_tpu.core import init as jinit
    from climate_model_tpu_torch import graphs
    from climate_model_tpu_torch.core.init import initialize

    from .test_torch_core import jax_cfg
    cfg = small_cfg()
    monkeypatch.setenv("CLIMATE_TPU_PACKED_SCAN", "1")
    js, jf, jg = jinit.initialize(jax_cfg(cfg))
    ref = jmodel.make_chunk_runner(jax_cfg(cfg), 12)(js, jg, jf)
    s, f, g = initialize(cfg, device="cpu")
    out = graphs.make_graph_runner(cfg, 12, capture=StandInCapture)(s, g, f)
    assert out.step == int(ref.step) == 12
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-14)
    for name in FIELDS[:-1]:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)


# ---------------------------------------------------------------------------
# A mesh in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True],
                         ids=["blocking", "overlap"])
def test_2x2_equals_eager(monkeypatch, overlap):
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.dist.mesh import make_mesh
    cfg = small_cfg((2, 2), overlap)

    def split(st, g, f):
        return sharding.shard(make_mesh(cfg, device="cpu"), st, g, f)

    _, out = both(monkeypatch, cfg, split)
    (a, ca, _), (b, cb, caps) = out["eager"], out["graphs"]
    assert all(same(a, b).values()), same(a, b)
    assert ca == cb and caps == 4
    n = sum(CHUNKS)
    strips = 2 * n if overlap else 0          # a seam a lon column
    assert launched(cb) == {
        "predictor.shard": 4 * n, "corrector.shard": 4 * n,
        **({"predictor.south_strip": strips,
            "predictor.north_strip": strips,
            "corrector.south_strip": strips,
            "corrector.north_strip": strips} if overlap else {}),
        "radiation.refreshes": 4 * 4}


# ---------------------------------------------------------------------------
# Across ranks: the static exchange buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "1x4", "4x1"])
def test_static_buffers_equal_cat(shape, monkeypatch):
    """``DistExchange`` with its buffers allocated once writes the same
    ghosts as with ``cat`` and unpacking, twice over (the buffers are
    reused), under the tag-blind transport of ``test_torch_multicard``."""
    import torch

    from climate_model_tpu_torch.dist import comm

    from .test_torch_multicard import (TagBlind, garbled_blocks, on_ranks,
                                       same_blocks)
    mesh, lays, blocks, _ = garbled_blocks(shape)
    got = {}
    for static in (False, True):
        net = TagBlind()
        monkeypatch.setattr(comm, "tdist", net)

        def rank(r):
            ex = comm.DistExchange(dataclasses.replace(mesh, rank=r), lays)
            if static:
                ex.use_static_buffers()
            mine = [x.clone() for x in blocks[r]]
            ex.refresh([mine])
            again = [x * 2 for x in blocks[r]]
            ex.refresh([again])
            return mine + again, ex.static
        res = on_ranks(mesh.size, rank, net)
        got[static] = [m for m, _ in res]
        bufs = [b for _, b in res]
        assert (bufs[0] is not None) == static
    assert same_blocks(got[False], got[True])
    assert torch.equal(got[True][0][0], got[False][0][0])


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


MP_MESHES = ((1, 2, False), (2, 1, True))    # lat, lon, halo overlap


def _rank(rank: int, port: int, out: str):
    # the lowest priority first, and the imports here: see
    # test_torch_dist_mp.py::_rank
    os.nice(19)
    import torch
    import torch.distributed as tdist

    from climate_model_tpu_torch import graphs, model
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.dist.mesh import make_mesh

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=2)
    try:
        res = {}
        for n_lat, n_lon, overlap in MP_MESHES:
            cfg = small_cfg((n_lat, n_lon), overlap)
            s, f, g = initialize(cfg, device="cpu")
            for name, runner_for in (
                    ("eager", lambda n: model.make_chunk_runner(
                        cfg, n, graphs=False)),
                    ("graphs", lambda n: graphs.make_graph_runner(
                        cfg, n, capture=StandInCapture))):
                c0 = graphs.captures
                ss = sharding.shard(make_mesh(cfg, device="cpu"), s, g, f)
                st = run_chunks(runner_for, ss, g, f)
                res[(n_lat, n_lon, name)] = dict(
                    state={k: getattr(st.states[0], k) for k in FIELDS},
                    step=st.states[0].step,
                    captures=graphs.captures - c0,
                    static=ss.exchange.static is not None)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("graph_ranks")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} ranks still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    return out


@pytest.mark.parametrize("mesh", MP_MESHES,
                         ids=["1x2", "2x1-overlap"])
def test_gloo_ranks_equal_eager(gloo_ranks, mesh):
    """Two gloo ranks, a shard each: the stand-in's run through the static
    exchange buffers equals the eager run bit for bit on every rank, with
    4 captures and no re-capture after the dt change."""
    import torch
    n_lat, n_lon, _ = mesh
    for r in range(2):
        got = torch.load(gloo_ranks / f"rank{r}.pt")
        a, b = got[(n_lat, n_lon, "eager")], got[(n_lat, n_lon, "graphs")]
        assert a["step"] == b["step"] == sum(CHUNKS)
        for k in FIELDS:
            assert torch.equal(a["state"][k], b["state"][k]), (r, k)
        assert b["captures"] == 4 and a["captures"] == 0
        assert b["static"] and not a["static"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from climate_model_tpu_torch.kernels import fused_substep as fs
    fs.build()
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_capture_equals_eager(card):
    """#3 cut to 64x32x8 in fp32 on the card: the captured chunks equal the
    eager ones bit for bit, with no capture after the dt change."""
    import torch

    from climate_model_tpu_torch import graphs, model
    from climate_model_tpu_torch.core.init import initialize
    cfg = small_cfg().replace(dtype="float32")
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, nx=64, ny=32))
    assert cfg.physics.rad_every_steps == 7
    s, f, g = initialize(cfg, device=card)
    a = run_chunks(lambda n: model.make_chunk_runner(cfg, n, graphs=False),
                   s, g, f)
    c0 = graphs.captures
    b = run_chunks(lambda n: model.make_chunk_runner(cfg, n), s, g, f)
    torch.cuda.synchronize(card)
    assert graphs.captures - c0 == 4
    assert all(same(a, b).values()), same(a, b)


@pytest.mark.gpu
def test_card_capture_with_host_sync_raises(card):
    """A host sync inside a capture raises; nothing runs it eagerly in its
    place."""
    import torch

    from climate_model_tpu_torch import graphs
    cap = graphs.CudaCapture(card)
    x = torch.ones(4, device=card)
    ran = []

    def step():
        ran.append(float(x.sum()))          # .item(): a host sync
    with pytest.raises(RuntimeError):
        cap(step)
    assert not ran
