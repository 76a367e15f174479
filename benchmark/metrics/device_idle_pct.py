"""Share of the traced window in which no kernel or copy ran on the card
(the union of the device operations' intervals), in %; the largest over
the ranks."""

from benchmark import trace


def read(run: dict):
    out = []
    for r in run["ranks"]:
        w = trace.window(r["trace"])
        if w is None or not r["trace"]["ops"]:
            continue
        busy = trace.busy_ns(r["trace"]["ops"], *w)
        out.append(100.0 * (1.0 - busy / (w[1] - w[0])))
    return max(out) if out else None
