"""The whole RK4 step's share of the card's peak: the least time of a step
on one chip at the published peaks (``reference_rk4/counts.py``: the RK4
step's bytes at the run record's dtype and its operations, each chip's
share of the grid) over the traced window's wall time a step, in %. None
where the window holds no launch of the RK4 stage kernel."""

from benchmark import trace
from benchmark.reference_rk4 import counts


def read(run: dict):
    r = run["ranks"][0]
    w = trace.window(r["trace"])
    steps = sum(c["n"] for c in r["traced_calls"])
    if w is None or not steps or run["peaks"] is None:
        return None
    if not any(counts.stage_of(name) and e > w[0] and s < w[1]
               for name, s, e, _, _ in r["trace"]["ops"]):
        return None
    nx, ny, nz = run["grid"]
    chips = run["chips"]
    least = counts.least_s(
        counts.step_bytes(nx, ny, nz, run["rad_every_steps"],
                          counts.dtype_bytes(run["dtype"])) / chips,
        counts.step_flops(nx, ny, nz) / chips, run["peaks"])
    return 100.0 * least / ((w[1] - w[0]) / 1e9 / steps)
