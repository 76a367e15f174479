"""Host time inside the runner calls of the traced window, ms a step: what
``cli.run``'s call into the compiled chunk costs the host before the
device finishes (the harness's ``bench.runner`` spans). The largest over
the ranks."""


def read(run: dict):
    out = []
    for r in run["ranks"]:
        spans = [s for s in r["trace"]["spans"] if s[0] == "bench.runner"]
        steps = sum(c["n"] for c in r["traced_calls"])
        if spans and steps:
            out.append(sum(e - s for _, s, e in spans) / steps / 1e6)
    return max(out) if out else None
