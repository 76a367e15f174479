"""Host time inside ``NCWriter.write`` and ``save_checkpoint`` within the
traced window, ms a chunk (the harness's ``bench.nc_write`` and
``bench.checkpoint`` spans). Nothing to read where the cell writes no
files."""

from benchmark import trace


def read(run: dict):
    r = run["ranks"][0]
    w = trace.window(r["trace"])
    spans = [s for s in r["trace"]["spans"]
             if s[0] in ("bench.nc_write", "bench.checkpoint")]
    if w is None or not spans:
        return None
    inside = sum(min(e, w[1]) - max(s, w[0]) for _, s, e in spans
                 if e > w[0] and s < w[1])
    return inside / len(r["traced_calls"]) / 1e6
