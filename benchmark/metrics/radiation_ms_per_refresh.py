"""A radiation refresh's device time, ms: the device time (union) of each
step replay launched inside the program's ``cm.step.radiation`` span, less
that of the median plain replay of the same traced chunks, averaged over
the refreshes; the slowest rank (``spans.radiation_ms_per_refresh``)."""

from benchmark.spans import radiation_ms_per_refresh


def read(run: dict):
    return radiation_ms_per_refresh(run)
