"""The program's own spans: ``torch.profiler`` ranges named ``cm.<what>``.

A span is a ``record_function`` range, so under ``torch.profiler`` it lies
on the same clock as the device activity the profiler records; with the
profiler off it costs a few microseconds. There is no other recorder, clock
or switch. The spans mark where the host loop's work happens:

* ``cm.chunk`` one iteration of ``cli.run``'s chunk loop, around
  ``cm.runner`` (the chunk runner's call), ``cm.gather`` (a mesh's blocks
  gathered), ``cm.diagnostics`` (with ``cm.diagnostics.fetch``, the one
  copy to the host), ``cm.log`` (the step line and JSONL record) and the
  output: ``cm.output.snapshot`` and ``cm.output.checkpoint``, each with a
  ``.fetch`` (the copy off the device) and a ``.write`` (the file);
* ``cm.step.radiation`` the replay of a captured step that refreshes the
  radiation (``graphs.py``), and ``cm.capture`` a runner's warm-up and
  captures.

No span is opened inside a function that is captured: a replay runs no
Python, so a range recorded at capture would measure nothing.
"""

from __future__ import annotations

import torch

PREFIX = "cm."


def span(name: str):
    """The range ``cm.<name>``, as a context manager."""
    return torch.profiler.record_function(PREFIX + name)
