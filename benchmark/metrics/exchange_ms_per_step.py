"""The ghost exchange's device time a step, ms: within the steps' graph
replays of the traced runner calls, the NCCL kernels and the copies (the
exchange's packs and unpacks, the seam strips' cuts and splices), on the
slowest rank. The chunk's copies in and out and the per-chunk gather run
outside the replays and are left out, as are the radiation refresh's
concatenations (``CatArrayBatchedCopy``); the refresh's few other copies,
once a refresh, stay in. Nothing to read on one card."""

from benchmark import trace


def is_exchange(name: str) -> bool:
    low = name.lower()
    if "catarray" in low:
        return False
    return "nccl" in low or "copy" in low or "memcpy" in low


def read(run: dict):
    if run["chips"] < 2:
        return None
    out = []
    for r in run["ranks"]:
        ops = [op for chunk in trace.chunk_ops(r["trace"]) for op in chunk
               if op[4]]
        t = sum(e - s for name, s, e, _, _ in ops if is_exchange(name))
        steps = sum(c["n"] for c in r["traced_calls"])
        if steps and ops:
            out.append(t / steps / 1e6)
    return max(out) if out else None
