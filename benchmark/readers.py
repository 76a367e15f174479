"""Shared by the kernels' roofline readers (``metrics/roofline_pct.*.py``): a
substep's counted bytes and operations over its launches' summed device
time in the traced window, in %, over every rank (each rank's block counted
from its shape)."""

from benchmark import counts, trace


def share(run: dict, kind: str, names: tuple):
    if run["peaks"] is None:
        return None
    nx, ny, nz = run["grid"]
    lat, lon = run["mesh"]
    least = busy = 0.0
    for r in run["ranks"]:
        w = trace.window(r["trace"])
        if w is None:
            continue
        t = sum(min(e, w[1]) - max(s, w[0]) for name, s, e, _, _
                in r["trace"]["ops"]
                if any(k in name for k in names) and e > w[0] and s < w[1])
        steps = sum(c["n"] for c in r["traced_calls"])
        shape = (nx // lon, ny // lat, nz)
        least += steps * counts.least_s(counts.substep_bytes(kind, *shape),
                                        counts.substep_flops(kind, *shape),
                                        run["peaks"])
        busy += t / 1e9
    return 100.0 * least / busy if busy > 0 else None
