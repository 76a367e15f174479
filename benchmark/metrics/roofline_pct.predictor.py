"""The predictor kernel's share of its roofline (``substep_kernel<true>``:
every launch, shard-local and seam strips included), in %."""

from benchmark.readers import share


def read(run: dict):
    return share(run, "predictor", ("substep_kernel<true>",))
