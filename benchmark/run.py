"""Run one cell of the benchmark of ``climate_model_tpu_torch`` once.

    python3 benchmark/run.py --workload bl3_run --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the cell's cards. Prints the
numbers compared, each beside its limit, as the last lines of standard
error, and one JSON object as the last line of standard output. A cell on
four cards starts its ranks itself (``torch.distributed.run``, one rank a
card, NCCL); rank 0 gathers the readings and this process prints the line.
Exits non-zero, printing no result, without the cards the cell asks for,
or if ``jax``, ``jaxlib``, ``flax`` or ``climate_model_tpu`` was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if sys.path and os.path.abspath(sys.path[0] or ".") == BENCH:
    sys.path.pop(0)
sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout (the port builds its own
# CUDA library into climate_model_tpu_torch/_build/)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)

MARK = "BENCH_RESULT "


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank-worker", action="store_true",
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def emit(line: dict, info: dict):
    """How the run went and the numbers compared on standard error, then
    the result line."""
    print("run: " + json.dumps({k: info[k] for k in (
        "setup_s", "setup_parts", "wall_s", "chunks", "steps", "compare",
        "reference_s")}),
          file=sys.stderr, flush=True)
    checks = line["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    for c in checks.values():
        c["value"] = _finite(c["value"])
    print(json.dumps(line), flush=True)


def forbidden_loaded() -> list:
    from benchmark.harness import loaded_forbidden
    found = loaded_forbidden()
    if found:
        print(f"error: modules loaded that the benchmark may not load: "
              f"{found}", file=sys.stderr, flush=True)
    return found


def launch(args, chips: int) -> int:
    """Start the cell's ranks, relay their output, print rank 0's line."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(chips), os.path.abspath(__file__),
           "--workload", args.workload, "--seed", str(args.seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--rank-worker"]
    env = dict(os.environ, BENCH_T_START=repr(T_START))
    line = None
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env, cwd=ROOT,
                          text=True) as proc:
        for text in proc.stdout:
            if text.startswith(MARK):
                line, info = json.loads(text[len(MARK):])
            else:
                sys.stdout.write(text)
                sys.stdout.flush()
        rc = proc.wait()
    if rc != 0 or line is None:
        print(f"error: the ranks exited with {rc}", file=sys.stderr)
        return rc or 1
    if forbidden_loaded():
        return 3
    emit(line, info)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from benchmark import harness, report
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 2
    if cell.chips > 1 and not args.rank_worker:
        return launch(args, cell.chips)
    t_start = float(os.environ.get("BENCH_T_START", T_START))
    res = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_start=t_start)
    if res is None:             # a rank other than 0
        return 0
    if res["info"]["forbidden"] or forbidden_loaded():
        return 3
    line = report.result_line(cell, res, bool(args.trace),
                              harness.manifest())
    info = {k: v for k, v in res["info"].items() if k != "ranks"}
    if args.rank_worker:
        print(MARK + json.dumps([line, info]), flush=True)
        return 0
    emit(line, info)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
