"""The program's peak device memory over the run (``torch.cuda.
max_memory_allocated``, the harness's own copies of the compared chunk
left out), on the fullest card, in GiB. Nothing to read on a CPU run."""


def read(run: dict):
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
