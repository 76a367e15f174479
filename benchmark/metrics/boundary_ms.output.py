"""The output at each chunk boundary, ms a traced chunk: the device time of
the operations launched inside the program's ``cm.output.*`` spans (the
snapshot's and the checkpoint's fetches) and the idle time while the host
was inside them (the fetches' waits and the files), on the slowest rank
(``spans.boundary_ms``). Nothing to read where the cell writes no files."""

from benchmark.spans import boundary_ms


def read(run: dict):
    return boundary_ms(run, "output")
