"""The program's own spans in a traced window: the device timeline between
chunks split by part, and the radiation refresh's device time.

The port marks its host loop with ``record_function`` ranges named
``cm.<what>`` (``climate_model_tpu_torch/trace.py``): ``cm.chunk`` around
``cm.runner``, ``cm.gather``, ``cm.diagnostics``, ``cm.log`` and the
output (``cm.output.snapshot``, ``cm.output.checkpoint``, each with a
``.fetch`` and a ``.write``), and ``cm.step.radiation`` around each replay
of a step that refreshes the radiation. They lie on the profiler's clock,
as the device operations do, and ``trace.records`` keeps them as
``program_spans`` [(name, start, end)]. What reads them:

* ``boundary_ms(run, part)``: at the chunk boundaries (``boundaries``:
  from a runner call's last device operation to the next call's first),
  for a part ``X`` (``diagnostics``, ``gather``, ``output``, ...), the
  device time (the union) of the operations outside graph replays that
  were launched inside a ``cm.X`` span or one of its children, plus the
  idle time in which the host's innermost program span was one of them;
  ms a traced chunk, the largest over the ranks;
* ``radiation_ms_per_refresh(run)``: for each replay launched inside a
  ``cm.step.radiation`` span, the union of its operations' device time,
  less the median of that time over the plain replays of the same traced
  chunks; the mean over the refreshes, the largest over the ranks;
* ``host_at(rec, t)``: the innermost span, the harness's or the program's,
  the host was in; ``report.breakdown`` names the idle gaps by it.

The readers ``metrics/boundary_ms.*.py`` and
``metrics/radiation_ms_per_refresh.py`` read them in ``benchmark/run.py
--trace 1``. ``python3 benchmark/spans.py --workload NAME --seed N
--seconds S`` runs a cell so, and its result line holds every reading of
``metrics`` beside them (the parts no reader of ``BENCHMARK.json`` takes).
"""

from __future__ import annotations

import os
import statistics
import sys

if __name__ == "__main__":
    # run as a script from the checkout's root, as benchmark/run.py is
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path and os.path.abspath(sys.path[0] or ".") == \
            os.path.dirname(os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, _ROOT)

from benchmark import trace  # noqa: E402

PREFIX = trace.PROGRAM_PREFIX
RADIATION = PREFIX + "step.radiation"
PARTS = ("diagnostics", "gather", "output", "log", "runner", "step")
# the parts' children that ``metrics`` reads too
CHILDREN = ("diagnostics.fetch", "output.snapshot.fetch",
            "output.snapshot.write", "output.checkpoint.fetch",
            "output.checkpoint.write")


def _innermost(spans, t):
    inside = [s for s in spans if s[1] <= t <= s[2]]
    return max(inside, key=lambda s: (s[1], -s[2])) if inside else None


def host_at(rec: dict, t: int) -> str:
    """The innermost span, the harness's or the program's, that the host
    was in at ``t`` ('host loop' where it was in none)."""
    spans = [s for s in rec["spans"] if s[0] != "bench.trace_end"] \
        + rec["program_spans"]
    s = _innermost(spans, t)
    return s[0] if s else "host loop"


def _of_part(name: str, part: str) -> bool:
    return name == PREFIX + part or name.startswith(PREFIX + part + ".")


def _segments(spans, t0: int, t1: int) -> list:
    """[t0, t1] cut where the host's innermost program span changes:
    (start, end, name or None) in order."""
    cuts = sorted({t0, t1} | {t for s in spans for t in s[1:]
                              if t0 < t < t1})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        top = _innermost([s for s in spans if s[1] <= a and b <= s[2]], a)
        out.append((a, b, top[0] if top else None))
    return out


def _overlap(gaps, segs) -> int:
    """The time that the sorted, disjoint intervals ``gaps`` and ``segs``
    share."""
    total, j = 0, 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            total += max(0, min(b, segs[k][1]) - max(a, segs[k][0]))
            k += 1
    return total


def boundaries(rec: dict) -> list:
    """The device timeline between chunks: for each traced runner call,
    from the end of the last operation it launched to the start of the
    first that the next call launched (the window's end after the last
    call), as ``loop_gap_ms`` reads a chunk boundary."""
    w = trace.window(rec)
    per = trace.chunk_ops(rec)
    out = []
    for i, ops in enumerate(per):
        if not ops:
            continue
        nxt = per[i + 1] if i + 1 < len(per) else None
        if nxt == []:
            continue
        a = max(o[2] for o in ops)
        b = min(o[1] for o in nxt) if nxt else w[1]
        if b > a:
            out.append((a, b))
    return out


def part_ns(rec: dict, part: str) -> tuple:
    """(device, idle) ns of ``part`` at the chunk boundaries of one rank's
    traced window, or None where the window holds no span of the part."""
    w = trace.window(rec)
    if w is None:
        return None
    spans = rec["program_spans"]
    mine = [s for s in spans if _of_part(s[0], part)
            and s[2] > w[0] and s[1] < w[1]]
    if not mine:
        return None
    launched = [op for op in rec["ops"] if not op[4] and op[3] is not None
                and any(s[1] <= op[3] <= s[2] for s in mine)]
    segs = [s for s in _segments(spans, *w)
            if s[2] is not None and _of_part(s[2], part)]
    device = idle = 0
    for a, b in boundaries(rec):
        device += trace.busy_ns(launched, a, b)
        idle += _overlap(trace.idle_gaps(rec["ops"], a, b), segs)
    return device, idle


def boundary_ms(run: dict, part: str):
    """``part``'s device and idle time at the chunk boundaries, ms a traced
    chunk; the largest over the ranks (None where no rank's window holds
    the part)."""
    out = []
    for r in run["ranks"]:
        got = part_ns(r["trace"], part)
        if got is not None and r["traced_calls"]:
            out.append(sum(got) / len(r["traced_calls"]) / 1e6)
    return max(out) if out else None


def replay_ns(rec: dict) -> tuple:
    """The device time (union) of each graph replay of the traced runner
    calls, split into those launched inside a ``cm.step.radiation`` span
    and the others: (refreshing, plain) lists of ns."""
    rad = [s for s in rec["program_spans"] if s[0] == RADIATION]
    by_launch = {}
    for chunk in trace.chunk_ops(rec):
        for op in chunk:
            if op[4]:
                by_launch.setdefault(op[3], []).append(op)
    refreshing, plain = [], []
    for launch, ops in by_launch.items():
        ops.sort(key=lambda o: o[1])
        t = trace.busy_ns(ops, ops[0][1], max(o[2] for o in ops))
        inside = any(s[1] <= launch <= s[2] for s in rad)
        (refreshing if inside else plain).append(t)
    return refreshing, plain


def radiation_ms_per_refresh(run: dict):
    """A refreshing replay's device time over the median plain replay's,
    ms, averaged over the refreshes; the largest over the ranks."""
    out = []
    for r in run["ranks"]:
        refreshing, plain = replay_ns(r["trace"])
        if refreshing and plain:
            base = statistics.median(plain)
            out.append(sum(t - base for t in refreshing) / len(refreshing)
                       / 1e6)
    return max(out) if out else None


def refreshes_due(run: dict, r: dict) -> int:
    """The refreshes that the cadence gives over rank ``r``'s traced runner
    calls (the run starts at step 0)."""
    every = max(run["rad_every_steps"], 1)
    k = len(r["traced_calls"])
    start = r["calls"][0]["n"]
    due = 0
    for c in r["calls"][1:1 + k]:
        due += len(range(-(-start // every) * every, start + c["n"], every))
        start += c["n"]
    return due


def metrics(run: dict) -> dict:
    """Every reading of the program's spans, by name: ``boundary_ms.X`` for
    each of ``PARTS`` and ``CHILDREN``, ``radiation_ms_per_refresh``; and,
    on rank 0, the refreshing replays of the traced calls (``refreshes``)
    beside the cadence's count (``refreshes_due``). None where nothing was
    read."""
    out = {f"boundary_ms.{p}": boundary_ms(run, p)
           for p in PARTS + CHILDREN}
    out["radiation_ms_per_refresh"] = radiation_ms_per_refresh(run)
    r0 = run["ranks"][0]
    out["refreshes"] = len(replay_ns(r0["trace"])[0])
    out["refreshes_due"] = refreshes_due(run, r0)
    return out


# ---------------------------------------------------------------------------
# A cell run traced with every reading of the program's spans.
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """``benchmark/run.py``'s run of a cell, traced, with every reading of
    ``metrics`` in the result line (under ``program_spans``)."""
    from benchmark import report
    from benchmark import run as bench
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    result_line = report.result_line

    def line(cell, res, traced, manifest):
        out = result_line(cell, res, traced, manifest)
        if traced:
            checks = out.pop("checks")      # kept the line's last key
            out["program_spans"] = metrics(report.run_record(cell, res))
            out["checks"] = checks
        return out

    report.result_line = line
    # the ranks of a cell on several cards run this file too
    bench.__file__ = os.path.abspath(__file__)
    return bench.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
