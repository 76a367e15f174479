"""The RK4 stage kernel's share of its roofline (``rk4_stage_kernel<m>``,
four launches a step), in %: each launch's counted bytes and operations
(``reference_rk4/counts.py``, by its stage, at the run record's dtype) at
the card's peaks, over the launches' summed device time in the traced
window; a launch cut by the window counts the share of its work that its
time inside holds. None without a stage launch in the window."""

from benchmark import trace
from benchmark.reference_rk4 import counts


def read(run: dict):
    if run["peaks"] is None:
        return None
    nx, ny, nz = run["grid"]
    lat, lon = run["mesh"]
    shape = (nx // lon, ny // lat, nz)
    width = counts.dtype_bytes(run["dtype"])
    least = busy = 0.0
    for r in run["ranks"]:
        w = trace.window(r["trace"])
        if w is None:
            continue
        for name, s, e, _, _ in r["trace"]["ops"]:
            stage = counts.stage_of(name)
            if stage is None or e <= w[0] or s >= w[1] or e <= s:
                continue
            inside = min(e, w[1]) - max(s, w[0])
            least += inside / (e - s) * counts.least_s(
                counts.stage_bytes(stage, *shape, width),
                counts.stage_flops(*shape), run["peaks"])
            busy += inside / 1e9
    return 100.0 * least / busy if busy > 0 else None
