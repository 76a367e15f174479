"""The traced run's records: ``torch.profiler``'s kineto events of the traced
chunks, reduced to the harness's spans and the device's operations, kept in
memory (no trace file is written).

The profiler is prepared once the first chunk, which captures the graphs,
has been enqueued, starts at the window's first runner call and stops at the
runner call ``trace_chunks`` later, so the traced window holds whole chunks
with their host loop between them. The harness's spans are
``record_function`` ranges named ``bench.<what>`` around its calls into the
program; the program's own are named ``cm.<what>``
(``climate_model_tpu_torch/trace.py``; the prefix is a literal here, so
that the benchmark imports nothing of the port), read by ``spans.py``. A
device operation is tied to the runner call that launched it by
the correlation id of its launch, and to a step's graph replay where that
launch is a ``cudaGraphLaunch`` (every operation of a replay carries the
replay's correlation id).
"""

from __future__ import annotations

import torch
from torch.autograd import DeviceType

SPAN_PREFIX = "bench."
PROGRAM_PREFIX = "cm."


class Tracer:
    """Kineto tracing of CPU spans and, on a card, the device's work."""

    def __init__(self, cuda: bool):
        from torch.autograd.profiler import profile
        self._prof = profile(use_device="cuda" if cuda else None,
                             use_kineto=True)
        self.events = None

    def prepare(self):
        self._prof._prepare_trace()

    def start(self):
        self._prof._start_trace()

    def stop(self):
        """Stop tracing and keep the raw events (no parse into a tree)."""
        from torch.autograd import _disable_profiler
        result = _disable_profiler()
        self._prof.entered = False
        self.events = list(result.events())


def records(events, rank: int) -> dict:
    """The spans and device operations of a traced window, times in ns on
    the trace's clock: ``spans`` [(name, start, end)] the harness's,
    ``program_spans`` the same of the program's, ``ops`` [(name, start,
    end, launch, replay)], ``launch`` the host time of the call that
    launched the op (None where the trace does not link it), ``replay``
    whether that call was a graph launch."""
    spans, program, launches, dev = [], [], {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                spans.append((name, ev.start_ns(), ev.end_ns()))
            elif name.startswith(PROGRAM_PREFIX):
                program.append((name, ev.start_ns(), ev.end_ns()))
            elif name.startswith("cuda") and ev.correlation_id():
                # a CUDA runtime call (cudaLaunchKernel, cudaGraphLaunch,
                # cudaMemcpyAsync, ...): its correlation id is the one of
                # the device operations it launched
                launches[ev.correlation_id()] = (
                    ev.start_ns(), "GraphLaunch" in name)
        elif not (ev.is_user_annotation() or name.startswith(SPAN_PREFIX)):
            # a span's shadow on the device timeline is no operation
            dev.append(ev)
    ops = []
    for ev in dev:
        launch, replay = launches.get(ev.correlation_id(), (None, False)) \
            if ev.correlation_id() else (None, False)
        ops.append((ev.name(), ev.start_ns(), ev.end_ns(), launch, replay))
    spans.sort(key=lambda s: s[1])
    program.sort(key=lambda s: (s[1], -s[2]))
    ops.sort(key=lambda o: o[1])
    return dict(rank=rank, spans=spans, program_spans=program, ops=ops)


def window(rec: dict) -> tuple:
    """(start, end) of the traced window: the first runner span's start to
    the mark the harness leaves as tracing stops."""
    runs = [s for s in rec["spans"] if s[0] == "bench.runner"]
    marks = [s for s in rec["spans"] if s[0] == "bench.trace_end"]
    if not runs or not marks:
        return None
    return runs[0][1], marks[-1][1]


def busy_ns(ops, t0: int, t1: int) -> int:
    """Time in [t0, t1] in which some device operation ran (the union of
    the operations' intervals)."""
    busy, cur_s, cur_e = 0, None, None
    for _, s, e, _, _ in ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(ops, t0: int, t1: int) -> list:
    """The intervals of [t0, t1] in which no device operation ran."""
    gaps, edge = [], t0
    for _, s, e, _, _ in ops:
        if e <= t0 or s >= t1:
            continue
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    return gaps


def chunk_ops(rec: dict) -> list:
    """For each traced runner call, the device operations it launched.

    ``cli.run`` reads each chunk's diagnostics on the host before its next
    runner call, so a chunk's device work has ended before the next call
    begins (and the last traced call's before the window closes). An
    operation that the trace links to a call but that ends later belongs
    to no chunk and is left out."""
    import bisect
    runs = [s for s in rec["spans"] if s[0] == "bench.runner"]
    starts = [s for _, s, _ in runs]
    w = window(rec)
    ends = starts[1:] + [w[1] if w else None]
    out = [[] for _ in runs]
    for op in rec["ops"]:
        launch = op[3]
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= runs[i][2] and op[1] >= runs[i][1] \
                and (ends[i] is None or op[2] <= ends[i]):
            out[i].append(op)
    return out
