"""The program's spans in a traced window (``trace.records``'
``program_spans``, read by ``benchmark/spans.py``), on
hand-made profiler events in the style of ``test_benchmark_trace.py``:
three chunks, 100 ms apart, each a runner call (a copy in, two step
replays, a copy out), then the chunk diagnostics (a reduction, a fetch and
the wait for the chunk), the step line and a NetCDF snapshot (a fetch and a
file), under the harness's spans and the program's ``cm.`` ranges (with
their shadows on the device timeline). The first and last chunk's first
replay refreshes the radiation, 3 ms longer on the device. All times in ms
from the chunk's start:

    host:   cm.runner 0-6 (bench.runner 1-5.8), cm.diagnostics 6-70
            (.fetch 8-70), cm.log 70-72, cm.output.snapshot 72-85 (.fetch
            72-76, .write 76-85), all inside cm.chunk 0-90
    device: copy in 3-4, replays 4-19 (22 with a refresh) and 24-39, copy
            out 40-45, reduction 45-48, fetch 48-49, snapshot copy 73-75

A second rank gathers its blocks (cm.gather 5.9-6.0, an NCCL kernel at
45-46) and waits 5 ms longer in its diagnostics fetch.
"""

import importlib.util
import json
import os

import pytest

from benchmark import counts, harness, report, spans, trace

from ._small import run_small
from .test_benchmark_trace import Ev

MS = 1_000_000
METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")
CHUNKS = 3
REFRESHING = (0, 2)
# the readers of the program's spans
PROGRAM_READERS = ("boundary_ms.diagnostics", "boundary_ms.gather",
                   "boundary_ms.output", "radiation_ms_per_refresh")


class Span(Ev):
    """A ``record_function`` range: on the host, or its shadow on the
    device timeline."""

    def __init__(self, name, start, end, cpu=True):
        super().__init__(name, start, end, 0, cpu)

    def is_user_annotation(self):
        return True


def ms(t):
    return int(round(t * MS))


def chunk_events(c, corr, gather=False, slow=0.0, program=True):
    """Chunk ``c``'s events from correlation id ``corr`` on; ``program``
    False leaves out the program's ranges and their shadows."""
    t0 = c * 100.0
    ev, dev = [], []

    def at(t):
        return ms(t0 + t)

    def launch(name, t, ops):
        nonlocal corr
        ev.append(Ev(name, at(t), at(t) + 10, corr))
        for op, a, b in ops:
            dev.append(Ev(op, at(a), at(b), corr, cpu=False))
        corr += 1

    refresh = c in REFRESHING
    ev.append(Ev("bench.runner", at(1), at(5.8)))
    launch("cudaMemcpyAsync", 1.5, [("Memcpy DtoD (Device -> Device)", 3, 4)])
    launch("cudaGraphLaunch", 2.2,
           [("substep_kernel<true>", 4, 12), ("epilogue_kernel", 12, 19)]
           + ([("radiation_elementwise", 19, 22)] if refresh else []))
    launch("cudaGraphLaunch", 3.0,
           [("substep_kernel<false>", 24, 31), ("epilogue_kernel", 31, 39)])
    launch("cudaLaunchKernel", 4.0, [("direct_copy_kernel_cuda", 40, 45)])
    red = 45
    if gather:
        launch("cudaLaunchKernel", 5.95, [("ncclDevKernel_AllGather", 45,
                                           46)])
        red = 46
    launch("cudaLaunchKernel", 7.0, [("reduce_kernel", red, 48)])
    launch("cudaMemcpyAsync", 8.5, [("Memcpy DtoH (Device -> Pageable)",
                                     48, 49)])
    d = 70 + slow
    ev.append(Ev("bench.diagnostics", at(5.99), at(d + 0.01)))
    launch("cudaLaunchKernel", d + 2.5, [("cat_kernel", d + 3, d + 5)])
    ev.append(Ev("bench.nc_write", at(d + 1.9), at(d + 15.1)))
    if program:
        cm = [("cm.chunk", 0, 90), ("cm.runner", 0, 6),
              ("cm.diagnostics", 6, d), ("cm.diagnostics.fetch", 8, d),
              ("cm.log", d, d + 2), ("cm.output.snapshot", d + 2, d + 15),
              ("cm.output.snapshot.fetch", d + 2, d + 6),
              ("cm.output.snapshot.write", d + 6, d + 15)]
        if refresh:
            cm.append(("cm.step.radiation", 2.1, 2.5))
        if gather:
            cm.append(("cm.gather", 5.9, 6.0))
        for name, a, b in cm:
            ev.append(Span(name, at(a), at(b)))
        # the device's shadows of the ranges that launched work
        dev += [Span("cm.chunk", at(3), at(49), cpu=False),
                Span("cm.diagnostics", at(45), at(49), cpu=False)]
    return ev + dev, corr


def window_events(gather=False, slow=0.0, program=True):
    ev, corr = [], 1
    for c in range(CHUNKS):
        got, corr = chunk_events(c, corr, gather, slow, program)
        ev += got
    ev.append(Ev("bench.trace_end", ms(300), ms(300) + 10))
    return ev


def run_of(ranks):
    """A run record of traced windows, a rank each (``ranks``: keyword
    sets of ``window_events``), read by ``trace.records``."""
    calls = [dict(n=2, dt=10.0)] * (1 + CHUNKS + 1)
    out = []
    for i, kw in enumerate(ranks):
        rec = trace.records(window_events(**kw), rank=i)
        out.append(dict(rank=i, calls=calls, traced_calls=calls[1:1 + CHUNKS],
                        trace=rec))
    return dict(cell="hand", chips=len(ranks), grid=(64, 32, 8),
                mesh=(1, len(ranks)), wall_s=1.0, steps=12, sim_s=120.0,
                setup_s=1.0, peak_bytes=0, rad_every_steps=4,
                dtype="float32", reference="reference",
                peaks=counts.peaks("NVIDIA H100 80GB HBM3"), ranks=out)


def read(name, run):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def test_program_spans_kept_and_the_rest_unchanged():
    with_ = trace.records(window_events(), rank=0)
    without = trace.records(window_events(program=False), rank=0)
    assert set(with_) == set(without) == {"rank", "spans", "program_spans",
                                          "ops"}
    assert without["program_spans"] == []
    assert with_["spans"] == without["spans"]
    assert with_["ops"] == without["ops"]
    names = [s[0] for s in with_["program_spans"]]
    assert names.count("cm.chunk") == CHUNKS
    assert names.count("cm.step.radiation") == len(REFRESHING)
    assert all(n.startswith("cm.") for n in names)
    assert [s[1] for s in with_["program_spans"]] == \
        sorted(s[1] for s in with_["program_spans"])


@pytest.mark.parametrize("ranks", [
    [{}], [{}, dict(gather=True, slow=5.0)]], ids=["one", "two-ranks"])
@pytest.mark.parametrize("name", [m["name"] for m in
                                  harness.manifest()["per_layer"]])
def test_existing_readers_read_the_same(name, ranks):
    """Every reader that reads none of the program's spans reads the same
    with them; one that reads them reads nothing without them."""
    plain = run_of([dict(kw, program=False) for kw in ranks])
    kept = run_of(ranks)
    if name in PROGRAM_READERS:
        assert read(name, plain) is None
    else:
        assert read(name, kept) == read(name, plain)


def test_existing_readers_read_something():
    """The hand-made window gives the accepted readers a value to compare
    (each rank's chunk boundary is 45 to 103 ms)."""
    run = run_of([{}])
    assert read("loop_gap_ms", run) == pytest.approx(58.0)
    for name in ("io_ms_per_chunk", "enqueue_ms_per_step", "step_mfu",
                 "roofline_pct.predictor", "roofline_pct.corrector",
                 "device_idle_pct"):
        assert read(name, run) is not None, name


@pytest.mark.parametrize("ranks,want", [
    # one rank: the parts of test_parts_of_one_rank, a refresh 3 ms
    ([{}], {"boundary_ms.diagnostics": 25.0, "boundary_ms.gather": None,
            "boundary_ms.output": 13.0, "radiation_ms_per_refresh": 3.0}),
    # the slower second rank, which gathers
    ([{}, dict(gather=True, slow=5.0)],
     {"boundary_ms.diagnostics": 29.0, "boundary_ms.gather": 1.0,
      "boundary_ms.output": 13.0, "radiation_ms_per_refresh": 3.0}),
], ids=["one", "two-ranks"])
def test_program_readers(ranks, want):
    run = run_of(ranks)
    for name in PROGRAM_READERS:
        got = read(name, run)
        assert got == (None if want[name] is None
                       else pytest.approx(want[name])), name


def test_boundaries():
    rec = trace.records(window_events(), rank=0)
    assert spans.boundaries(rec) == [(ms(45), ms(103)), (ms(145), ms(203)),
                                     (ms(245), ms(300))]


@pytest.mark.parametrize("part,want", [
    # device 45-49, idle 49-70 under the fetch
    ("diagnostics", 4 + 21),
    ("log", 2),
    # idle 72-73 and 75-76 under the fetch, its copy 73-75, the file 76-85
    ("output", 1 + 2 + 1 + 9),
    # the next call's 100-103 before its copy in, in two of three chunks,
    # less 202.1-202.5, the refreshing replay's launch
    ("runner", (3 + 2.6) / 3),
    ("step", 0.4 / 3),
    ("gather", None),
])
def test_parts_of_one_rank(part, want):
    got = spans.boundary_ms(run_of([{}]), part)
    assert got == (None if want is None else pytest.approx(want))


def test_parts_cover_the_boundary():
    """Diagnostics, log, output and the next runner call leave of each
    58 ms boundary the 5 ms left in cm.chunk after the snapshot and the
    10 ms outside every chunk."""
    run = run_of([{}])
    rec = run["ranks"][0]["trace"]
    full = sum(b - a for a, b in spans.boundaries(rec)[:2]) / 2 / MS
    # the two whole boundaries: the window's last ends before a runner call
    parts = sum(sum(spans.part_ns(rec, p)) for p in spans.PARTS
                if spans.part_ns(rec, p)) / MS
    last = (300 - 245) - 5 - 10
    assert parts == pytest.approx(2 * (full - 15) + last)


@pytest.mark.parametrize("part,want", [
    # the second rank: the fetch's wait 49-75, its reduction 46-49
    ("diagnostics", 3 + 26),
    ("gather", 1.0),
    ("output", 13.0),
])
def test_parts_take_the_slowest_rank(part, want):
    run = run_of([{}, dict(gather=True, slow=5.0)])
    assert spans.boundary_ms(run, part) == pytest.approx(want)


def test_idle_under_no_span_counts_for_no_part():
    rec = trace.records(window_events(), rank=0)
    segs = spans._segments(rec["program_spans"], ms(85), ms(103))
    assert segs == [(ms(85), ms(90), "cm.chunk"), (ms(90), ms(100), None),
                    (ms(100), ms(103), "cm.runner")]


def test_radiation_ms_per_refresh():
    # a refreshing replay 18 ms on the device, a plain one 15
    run = run_of([{}])
    refreshing, plain = spans.replay_ns(run["ranks"][0]["trace"])
    assert sorted(refreshing) == [ms(18)] * 2
    assert sorted(plain) == [ms(15)] * 4
    assert spans.radiation_ms_per_refresh(run) == pytest.approx(3.0)
    assert spans.radiation_ms_per_refresh(
        run_of([dict(program=False)])) is None


def test_refreshes_against_the_cadence():
    run = run_of([{}])
    # steps 2-7 traced at 2 a call, a refresh every 4 steps: at 4
    assert spans.refreshes_due(run, run["ranks"][0]) == 1
    got = spans.metrics(run)
    assert got["refreshes"] == len(REFRESHING)
    assert set(got) == {f"boundary_ms.{p}" for p in spans.PARTS
                        + spans.CHILDREN} | {
        "radiation_ms_per_refresh", "refreshes", "refreshes_due"}
    # the snapshot: its fetch 1 + 2 + 1 ms, its file 9
    assert got["boundary_ms.output.snapshot.fetch"] == pytest.approx(4.0)
    assert got["boundary_ms.output.snapshot.write"] == pytest.approx(9.0)
    assert got["boundary_ms.output.checkpoint.fetch"] is None


def test_breakdown_names_a_gap_by_the_innermost_span():
    run = run_of([{}])
    plain = report.breakdown(run_of([dict(program=False)]))
    named = report.breakdown(run)
    assert named["device_ops"] == plain["device_ops"]
    # the longest gaps: 75-103 ms, which the harness saw begin in its
    # NetCDF write and the program in the snapshot's fetch; 49-73 ms, in
    # the harness's diagnostics and the program's fetch of them
    assert plain["idle_gaps"][0] == ["bench.nc_write", 0.028]
    assert named["idle_gaps"][0] == ["cm.output.snapshot.fetch", 0.028]
    assert ["bench.diagnostics", 0.024] in plain["idle_gaps"]
    assert ["cm.diagnostics.fetch", 0.024] in named["idle_gaps"]
    assert [g[1] for g in named["idle_gaps"]] == \
        [g[1] for g in plain["idle_gaps"]]
    # a gap where the host was in no span at all
    assert spans.host_at(run["ranks"][0]["trace"], ms(95)) == "host loop"
    assert spans.host_at(run["ranks"][0]["trace"], ms(80)) == \
        "cm.output.snapshot.write"


def test_the_port_spans_reach_the_trace():
    """A small cell on the CPU through the whole harness: the chunk loop's
    spans lie in the traced window, once a traced chunk."""
    res = run_small("bl3_output", trace=True)
    rec = res["info"]["ranks"][0]["trace"]
    w = trace.window(rec)
    names = [s[0] for s in rec["program_spans"] if w[0] <= s[1] <= w[1]]
    for name in ("cm.chunk", "cm.runner", "cm.diagnostics",
                 "cm.diagnostics.fetch", "cm.log", "cm.output.snapshot",
                 "cm.output.snapshot.fetch", "cm.output.snapshot.write"):
        assert names.count(name) >= 2, name
    json.dumps(rec)
