"""The chunk diagnostics at each chunk boundary, ms a traced chunk: the
device time of the operations launched inside the program's
``cm.diagnostics`` span (a radiation pass and reductions) and the idle
time while the host was inside it (its fetch's wait), on the slowest rank
(``spans.boundary_ms``)."""

from benchmark.spans import boundary_ms


def read(run: dict):
    return boundary_ms(run, "diagnostics")
