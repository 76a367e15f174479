"""The result line of a run: the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics (``--trace 1``), each from its reader
``metrics/<name>.py``, with the device, the traced run's breakdown and,
last, every number compared beside its limit."""

from __future__ import annotations

import importlib.util
import os

import torch

from . import counts, spans, trace

BENCH = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def run_record(cell, res: dict) -> dict:
    """What the readers read: the window's totals, the configuration's
    working precision (``dtype``, so that a reader counts bytes at its
    width) and the reference that judged the run, and, per rank, its runner
    calls and traced records."""
    info = res["info"]
    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else None
    k = cell.traffic["trace_chunks"]
    ranks = []
    for r in info["ranks"]:
        ranks.append(dict(rank=r["rank"], calls=r["calls"],
                          traced_calls=r["calls"][1:1 + k],
                          trace=r["trace"]))
    return dict(cell=cell.name, chips=info["chips"], grid=info["grid"],
                mesh=tuple(cell.traffic["mesh"]), wall_s=info["wall_s"],
                steps=info["steps"], sim_s=info["sim_s"],
                setup_s=info["setup_s"], peak_bytes=info["peak_bytes"],
                rad_every_steps=info["rad_every_steps"], dtype=info["dtype"],
                reference=info["reference"],
                peaks=counts.peaks(card) if card else None, ranks=ranks)


def _device(info: dict, run: dict, traced: bool) -> dict:
    cuda = torch.cuda.is_available()
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=info["chips"], memory_peak_bytes=info["peak_bytes"])
    if traced:
        busy, win = [], None
        for r in run["ranks"]:
            w = trace.window(r["trace"])
            if w is None:
                continue
            busy.append(trace.busy_ns(r["trace"]["ops"], *w) / 1e9)
            if win is None:
                win = (w[1] - w[0]) / 1e9
        dev["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        dev["window_s"] = win or 0.0
    return dev


def breakdown(run: dict) -> dict:
    """Rank 0's device operations that took the most time in the traced
    window, by name, and its longest idle gaps, by the innermost span, the
    harness's or the program's, that the host was in when each began
    (``spans.host_at``)."""
    r = run["ranks"][0]
    w = trace.window(r["trace"])
    if w is None:
        return dict(device_ops=[], idle_gaps=[])
    by_name = {}
    for name, s, e, _, _ in r["trace"]["ops"]:
        if e > w[0] and s < w[1]:
            by_name[name] = by_name.get(name, 0) + min(e, w[1]) - max(s, w[0])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_gaps(r["trace"]["ops"], *w),
                  key=lambda g: g[0] - g[1])[:10]
    return dict(device_ops=[[n, v / 1e9] for n, v in ops],
                idle_gaps=[[spans.host_at(r["trace"], a), (b - a) / 1e9]
                           for a, b in gaps])


def result_line(cell, res: dict, traced: bool, manifest: dict) -> dict:
    info = res["info"]
    run = run_record(cell, res)
    group = manifest["per_layer"] if traced else manifest["end_to_end"]
    metrics = {}
    for m in group:
        if not applies(m, cell.name):
            continue
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=metrics,
                device=_device(info, run, traced))
    if traced:
        line["breakdown"] = breakdown(run)
    line["checks"] = {n: dict(value=v, limit=lim)
                      for n, v, lim in res["checks"]}
    return line
