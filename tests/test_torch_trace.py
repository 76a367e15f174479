"""The port's own spans (``climate_model_tpu_torch/trace.py``) under
``torch.profiler``, on the CPU at a small size.

``cli.run`` runs the packed scan through the compiled chunk with the
stand-in capture of ``test_torch_graphs.py`` (which reruns the captured
step on each replay), with files, in chunks of two steps:

* every span of the chunk loop is recorded once a chunk (``cm.gather`` on
  a mesh only; a checkpoint at the restart cadence), nested under
  ``cm.chunk``; the checkpoint at the end lies outside every chunk;
* ``cm.step.radiation`` ranges number the refresh replays, as the
  counter ``radiation.refreshes`` counts them;
* a run gives the same state, bit for bit, with the profiler on and off;
* no ``cm.`` range is opened inside the captured step: ``cm.capture``
  encloses each capture.
"""

import os

import pytest
import torch
from torch.profiler import record_function

from climate_model_tpu_torch import cli, graphs, trace
from climate_model_tpu_torch.trace import PREFIX

from .test_torch_graphs import FIELDS, StandInCapture, StandInGraph

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

# #3's physics and adaptive dt at a small size: chunks of a few steps,
# radiation on its interval, a checkpoint every 0.1 days and one at the end
DAYS = 0.1
ARGV = ["run", "--physics", "all", "--dtype", "float64", "--backend",
        "pallas", "--adaptive-dt", "--out-every-hours", "1", "--days", "0.2",
        "--restart-every-days", str(DAYS)]
ONE = ARGV + ["--nx", "16", "--ny", "10", "--nz", "4"]
MESH = ARGV + ["--nx", "32", "--ny", "16", "--nz", "8", "--mesh-lat", "2",
               "--mesh-lon", "2", "--halo-overlap"]
CAPTURED = "test.captured"


class MarkedCapture(StandInCapture):
    """The stand-in capture with the captured call inside a range of its
    own (the replays rerun the step without it)."""

    def __call__(self, fn):
        with record_function(CAPTURED):
            fn()
        return StandInGraph(fn)


@pytest.fixture(autouse=True)
def stand_in(monkeypatch):
    """The stand-in capture in place of ``CudaCapture``; no runner cached
    across tests, the counters put back as they were."""
    graphs.clear_cache()
    saved = trace.counts()
    monkeypatch.setattr(graphs, "CudaCapture", MarkedCapture)
    yield
    trace.reset_counts(saved)
    graphs.clear_cache()


class Span:
    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end

    def within(self, outer) -> bool:
        return outer.start <= self.start and self.end <= outer.end


def traced_spans(fn):
    """``fn()`` under the profiler (CPU, kineto's raw events: no parse into
    a tree); its result and the ranges named ``cm.`` or CAPTURED."""
    from torch.autograd import _disable_profiler
    from torch.autograd.profiler import profile
    prof = profile(use_kineto=True)
    prof._prepare_trace()
    prof._start_trace()
    try:
        out = fn()
    finally:
        events = _disable_profiler().events()
        prof.entered = False
    spans = [Span(e.name(), e.start_ns(), e.end_ns()) for e in events
             if e.name().startswith((PREFIX, CAPTURED))]
    return out, sorted(spans, key=lambda s: (s.start, -s.end))


def run(argv, out_dir, traced: bool):
    """``cli.run`` of ``argv`` on the compiled chunk; its result, the
    refreshes it counted and, traced, the spans."""
    graphs.clear_cache()
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    r0 = trace.counts()["radiation.refreshes"]

    def go():
        return cli.run(cfg, device="cpu", out_dir=out_dir, graphs=True)

    res, spans = traced_spans(go) if traced else (go(), None)
    return res, trace.counts()["radiation.refreshes"] - r0, spans


def named(spans, name):
    return [s for s in spans if s.name == name]


def ancestors(span, spans):
    """The names of the spans enclosing ``span``, innermost first."""
    up = [s for s in spans if s is not span and span.within(s)]
    return [s.name for s in sorted(up, key=lambda s: -s.start)]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The one-device and the mesh run, each traced once."""
    graphs.clear_cache()
    saved = trace.counts()
    mp = pytest.MonkeyPatch()
    mp.setattr(graphs, "CudaCapture", MarkedCapture)
    try:
        out = {name: run(argv, str(tmp_path_factory.mktemp(name)), True)
               for name, argv in (("one", ONE), ("mesh", MESH))}
    finally:
        mp.undo()
        trace.reset_counts(saved)
        graphs.clear_cache()
    return out


@pytest.mark.parametrize("where", ["one", "mesh"])
def test_spans_a_chunk_nested_under_chunk(traced, where):
    res, _, spans = traced[where]
    n = len(res.chunks)
    assert n >= 5 and not res.aborted
    # a checkpoint when a chunk reaches the restart cadence, and at the end
    every = max(int(DAYS * 86400.0 / res.dts[0]), 1)
    done = [res.start_step + sum(res.chunks[:k]) for k in range(n + 1)]
    saves = sum(b // every > a // every for a, b in zip(done, done[1:]))
    assert saves >= 1
    want = {"cm.chunk": n, "cm.runner": n, "cm.diagnostics": n,
            "cm.diagnostics.fetch": n, "cm.log": n, "cm.output.snapshot": n,
            "cm.output.snapshot.fetch": n, "cm.output.snapshot.write": n,
            "cm.output.checkpoint": saves + 1,
            "cm.output.checkpoint.fetch": saves + 1,
            "cm.output.checkpoint.write": saves + 1,
            "cm.gather": n if where == "mesh" else 0}
    assert {k: len(named(spans, k)) for k in want} == want
    last_chunk = named(spans, "cm.chunk")[-1]
    for name in want:
        for s in named(spans, name):
            up = ancestors(s, spans)
            if name == "cm.chunk":
                assert "cm.chunk" not in up
            elif name.endswith((".fetch", ".write")):   # a part's child
                assert up[0] == name.rsplit(".", 1)[0], (name, up)
            if name.startswith("cm.output.checkpoint") \
                    and s.start > last_chunk.end:
                assert "cm.chunk" not in up   # the checkpoint at the end
            elif name != "cm.chunk":
                assert "cm.chunk" in up, (name, up)


@pytest.mark.parametrize("where", ["one", "mesh"])
def test_radiation_spans_count_the_refreshes(traced, where):
    res, refreshes, spans = traced[where]
    shards = 4 if where == "mesh" else 1
    rad = named(spans, "cm.step.radiation")
    cfg = cli.build_config(cli.make_parser().parse_args(
        ONE if where == "one" else MESH))
    every = cfg.physics.rad_every_steps
    assert every > 1
    # the step counter from 0: a refresh at every multiple of ``every``
    assert len(rad) == len(range(0, res.steps, every)) > 1
    assert refreshes == shards * len(rad)
    assert all(ancestors(s, spans)[0] == "cm.runner" for s in rad)


@pytest.mark.parametrize("where", ["one", "mesh"])
def test_no_span_inside_the_captured_step(traced, where):
    _, _, spans = traced[where]
    caught = named(spans, CAPTURED)
    builds = named(spans, "cm.capture")
    assert len(builds) == 1
    # one runner: a capture a (buffer parity, refresh) key
    assert len(caught) == 4
    for c in caught:
        assert any(c.within(b) for b in builds)
        assert [s.name for s in spans if s.within(c)] == [CAPTURED]


def test_profiler_on_and_off_bit_for_bit(tmp_path):
    off, _, _ = run(ONE, str(tmp_path / "off"), False)
    on, _, _ = run(ONE, str(tmp_path / "on"), True)
    assert off.chunks == on.chunks and off.dts == on.dts
    for f in FIELDS:
        assert torch.equal(getattr(off.state, f), getattr(on.state, f)), f
    assert sorted(os.listdir(tmp_path / "off")) == \
        sorted(os.listdir(tmp_path / "on"))


def test_chunk_durations_take_the_monotonic_clock(tmp_path, monkeypatch):
    """A wall clock that steps back moves neither the loop's ``wall_s`` nor
    a chunk's: both are durations of ``time.perf_counter``."""
    import itertools
    import time
    back = itertools.count(2e9, -1000.0)
    monkeypatch.setattr(time, "time", lambda: next(back))
    res, _, _ = run(ONE, str(tmp_path), False)
    assert res.wall_s > 0
    assert all(r["wall_s"] > 0 and r["grid_points_per_s"] > 0
               for r in res.records)
