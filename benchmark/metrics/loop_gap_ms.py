"""The host loop's cost on the device timeline, ms a chunk: at each chunk
boundary of the traced window, from the end of the last device operation
that one runner call launched to the start of the first that the next one
launched (diagnostics, dt, output and the next call's own host work lie in
between). The mean over the boundaries; the largest over the ranks. A
boundary that reads below zero means the trace tied operations to the
wrong chunk: then nothing is read."""

from benchmark import trace


def read(run: dict):
    out = []
    for r in run["ranks"]:
        per = trace.chunk_ops(r["trace"])
        gaps = [min(o[1] for o in b) - max(o[2] for o in a)
                for a, b in zip(per, per[1:]) if a and b]
        if any(g < 0 for g in gaps):
            return None
        if gaps:
            out.append(sum(gaps) / len(gaps) / 1e6)
    return max(out) if out else None
