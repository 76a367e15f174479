"""The reduction of a traced window to chunks, and the readers built on it,
on hand-made profiler events: graph replays whose operations share their
launch's correlation id, copies launched outside the replays, an operation
the trace ties to the wrong chunk."""

import importlib.util
import os

import pytest
from torch.autograd import DeviceType

from benchmark import counts, report, trace

MS = 1_000_000
METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")


class Ev:
    """The part of a kineto event that ``trace.records`` reads."""

    def __init__(self, name, start, end, corr=0, cpu=True):
        self._n, self._s, self._e, self._c = name, start, end, corr
        self._cpu = cpu

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def device_type(self):
        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def is_user_annotation(self):
        return False


class Shadow(Ev):
    """A ``record_function`` range's shadow on the device timeline."""

    def __init__(self, name, start, end):
        super().__init__(name, start, end, 0, cpu=False)

    def is_user_annotation(self):
        return True


def _read(name, run):
    spec = importlib.util.spec_from_file_location(
        "m_" + name, os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def window_events(stray=False, program=False):
    """Three traced chunks of two steps each, 100 ms apart; each runner
    call copies the state in (a launch of its own), replays a step graph
    twice (a kernel, an NCCL kernel, a pack copy and a concatenation each)
    and copies the state out. The device runs a chunk from 10 to 60 ms
    after its call begins; the host loop follows until the next call.
    ``program`` adds the program's ``cm.`` ranges around the chunk, the
    runner call, the first replay (a radiation refresh) and the
    diagnostics, with their shadows on the device."""
    ev, corr = [], 1
    for c in range(3):
        t0 = c * 100 * MS
        if program:
            ev += [Ev("cm.chunk", t0, t0 + 80 * MS),
                   Ev("cm.runner", t0, t0 + 5 * MS),
                   Ev("cm.step.radiation", t0 + 2 * MS, t0 + 2 * MS + 20),
                   Ev("cm.diagnostics", t0 + 5 * MS, t0 + 70 * MS),
                   Ev("cm.diagnostics.fetch", t0 + 6 * MS, t0 + 70 * MS),
                   Shadow("cm.chunk", t0 + 10 * MS, t0 + 60 * MS),
                   Shadow("cm.step.radiation", t0 + 11 * MS, t0 + 30 * MS)]
        ev.append(Ev("bench.runner", t0, t0 + 5 * MS))
        ev.append(Ev("cudaMemcpyAsync", t0 + 1 * MS, t0 + 1 * MS + 10, corr))
        ev.append(Ev("Memcpy DtoD (Device -> Device)", t0 + 10 * MS,
                     t0 + 11 * MS, corr, cpu=False))
        corr += 1
        for k in range(2):
            ev.append(Ev("cudaGraphLaunch", t0 + (2 + k) * MS,
                         t0 + (2 + k) * MS + 10, corr))
            d0 = t0 + (11 + 20 * k) * MS
            ev += [Ev("substep_kernel<true>", d0, d0 + 15 * MS, corr,
                      cpu=False),
                   Ev("ncclDevKernel_SendRecv", d0 + 15 * MS, d0 + 17 * MS,
                      corr, cpu=False),
                   Ev("direct_copy_kernel_cuda", d0 + 17 * MS,
                      d0 + 18 * MS, corr, cpu=False),
                   Ev("CatArrayBatchedCopy_vectorized", d0 + 18 * MS,
                      d0 + 19 * MS, corr, cpu=False)]
            corr += 1
        ev.append(Ev("cudaLaunchKernel", t0 + 4 * MS, t0 + 4 * MS + 10,
                     corr))
        ev.append(Ev("direct_copy_kernel_cuda", t0 + 51 * MS, t0 + 60 * MS,
                     corr, cpu=False))
        corr += 1
        ev.append(Ev("bench.diagnostics", t0 + 5 * MS, t0 + 70 * MS))
    if stray:
        # launched in the first call, yet running in the third chunk
        ev.append(Ev("cudaLaunchKernel", 3 * MS, 3 * MS + 10, corr))
        ev.append(Ev("substep_kernel<false>", 250 * MS, 255 * MS, corr,
                     cpu=False))
    ev.append(Ev("bench.trace_end", 300 * MS, 300 * MS + 10))
    return ev


def run_of(events, chips=4):
    rec = trace.records(events, rank=0)
    calls = [dict(n=2, dt=10.0)] * 3
    return dict(chips=chips, ranks=[dict(rank=0, trace=rec,
                                         traced_calls=calls)])


def test_records_tie_ops_to_their_launch_and_replay():
    rec = trace.records(window_events(), rank=0)
    assert [s[0] for s in rec["spans"]].count("bench.runner") == 3
    assert len(rec["ops"]) == 3 * (2 + 2 * 4)
    replayed = [op for op in rec["ops"] if op[4]]
    assert len(replayed) == 3 * 2 * 4
    assert all(op[3] is not None for op in rec["ops"])
    assert trace.window(rec) == (0, 300 * MS)


@pytest.mark.parametrize("stray", [False, True])
def test_chunk_ops_whole_chunks(stray):
    rec = trace.records(window_events(stray), rank=0)
    per = trace.chunk_ops(rec)
    assert [len(ops) for ops in per] == [10, 10, 10]
    for c, ops in enumerate(per):
        assert min(o[1] for o in ops) == (c * 100 + 10) * MS
        assert max(o[2] for o in ops) == (c * 100 + 60) * MS


@pytest.mark.parametrize("stray", [False, True])
def test_loop_gap_ms(stray):
    # each boundary: the chunk's last op ends at 60 ms, the next call's
    # first op starts at 110 ms
    assert _read("loop_gap_ms", run_of(window_events(stray))) == \
        pytest.approx(50.0)


def test_loop_gap_ms_none_on_a_negative_gap(monkeypatch):
    # chunks that overlap on the device timeline: the trace tied an
    # operation to the wrong chunk, and nothing is read
    run = run_of(window_events())
    per = trace.chunk_ops(run["ranks"][0]["trace"])
    late = ("substep_kernel<false>", 150 * MS, 160 * MS, 3 * MS, False)
    per[0] = per[0] + [late]
    monkeypatch.setattr(trace, "chunk_ops", lambda rec: per)
    assert _read("loop_gap_ms", run) is None


@pytest.mark.parametrize("stray", [False, True])
def test_exchange_ms_per_step(stray):
    # a step's replay: 2 ms of NCCL and 1 ms of pack copies; the chunk's
    # copies in and out and the concatenation are left out
    run = run_of(window_events(stray))
    assert _read("exchange_ms_per_step", run) == pytest.approx(3.0)
    assert _read("exchange_ms_per_step", run_of(window_events(stray),
                                                chips=1)) is None


@pytest.mark.parametrize("name", [
    "loop_gap_ms", "io_ms_per_chunk", "enqueue_ms_per_step", "step_mfu",
    "roofline_pct.predictor", "roofline_pct.corrector",
    "exchange_ms_per_step", "device_idle_pct"])
@pytest.mark.parametrize("stray", [False, True])
def test_readers_read_the_same_with_program_spans(name, stray):
    """The program's spans are kept beside the harness's, and every reader
    that the benchmark had before them reads what it read without them."""
    kept = trace.records(window_events(stray, program=True), rank=0)
    plain = trace.records(window_events(stray), rank=0)
    assert [s[0] for s in kept["program_spans"]].count("cm.chunk") == 3
    assert plain["program_spans"] == []
    assert (kept["spans"], kept["ops"]) == (plain["spans"], plain["ops"])
    with_, without = (run_of(window_events(stray, program=p))
                      for p in (True, False))
    for run in (with_, without):
        run.update(grid=(64, 32, 8), mesh=(1, 1), rad_every_steps=4,
                   peaks=counts.peaks("NVIDIA H100 80GB HBM3"))
    got = _read(name, with_)
    assert got == _read(name, without)
    # the window writes no files and launches no corrector (but a stray)
    if name not in ("io_ms_per_chunk", "roofline_pct.corrector"):
        assert got is not None


def test_device_idle_and_breakdown():
    run = run_of(window_events())
    # busy 10..30, 31..50 and 51..60 ms of every 100 ms chunk
    assert _read("device_idle_pct", run) == pytest.approx(52.0)
    out = report.breakdown(run)
    assert out["device_ops"][0] == ["substep_kernel<true>", 0.09]
    assert out["idle_gaps"][0] == ["bench.diagnostics", 0.05]
