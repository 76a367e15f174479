"""The whole step's share of the card's peak: the least time of a step on
one chip at the published peaks (``counts.py``: the step's bytes and
operations, each chip's share of the grid) over the traced window's wall
time a step, in %."""

from benchmark import counts, trace


def read(run: dict):
    r = run["ranks"][0]
    w = trace.window(r["trace"])
    steps = sum(c["n"] for c in r["traced_calls"])
    if w is None or not steps or run["peaks"] is None:
        return None
    nx, ny, nz = run["grid"]
    chips = run["chips"]
    least = counts.least_s(
        counts.step_bytes(nx, ny, nz, run["rad_every_steps"]) / chips,
        counts.step_flops(nx, ny, nz) / chips, run["peaks"])
    return 100.0 * least / ((w[1] - w[0]) / 1e9 / steps)
