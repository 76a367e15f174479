"""The gather of a mesh's blocks at each chunk boundary, ms a traced
chunk: the device time of the operations launched inside the program's
``cm.gather`` span (the collectives and copies) and the idle time while
the host was inside it, on the slowest rank (``spans.boundary_ms``).
Nothing to read on one card."""

from benchmark.spans import boundary_ms


def read(run: dict):
    return boundary_ms(run, "gather")
