"""The program's own spans and counters.

**Spans**: ``torch.profiler`` ranges named ``cm.<what>``. A span is a
``record_function`` range, so under ``torch.profiler`` it lies on the same
clock as the device activity the profiler records; with the profiler off it
costs a few microseconds. There is no other recorder, clock or switch. The
spans mark where the host loop's work happens:

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

**Counters**: one registry of named counts for the process, which the code
that launches or calls a thing moves with ``count``:

* the kernel wrappers (``kernels/fused_substep.py``), a launch each, on the
  card only (on the CPU they call their plain versions and count nothing):
  ``predictor`` and ``corrector`` on a whole grid with the v wall by row
  index, ``predictor.masked`` and ``corrector.masked`` with the wall mask,
  ``corrector.epilogue`` with the physics epilogue, and on a shard's block
  and its seam strips ``<wrapper>.shard``, ``.south_strip`` and
  ``.north_strip``; ``rk4_stage.k1`` to ``.k4``; ``epilogue`` (the physics
  epilogue launched alone);
* ``halo_copy.launches`` and ``halo_copy.slabs``, a launch of the ghost
  exchange's batched slab copy (``kernels/halo_copy.py``: a pack, an
  unpack, a seam strip's cut or splice) and the slabs it copied, on the
  card only;
* ``radiation.refreshes``, a recomputation of the radiation caches each;
* ``surface.calls``, ``turbulence.calls`` and ``microphysics.calls``, the
  plain physics splits.

A captured step runs no Python when it is replayed: the compiled chunk
(``graphs.py``) keeps what each capture counted, the difference of two
``counts()``, and adds it on each replay (``add_counts``).
"""

from __future__ import annotations

import collections

import torch

PREFIX = "cm."

_counts = collections.Counter()


def span(name: str):
    """The range ``cm.<name>``, as a context manager."""
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1):
    """Move the counter ``name`` by ``n``."""
    _counts[name] += n


def counts() -> collections.Counter:
    """A copy of every counter, by name; a name never counted reads 0, and
    two copies compare equal where they differ only in zeros."""
    return collections.Counter(_counts)


def add_counts(delta):
    """Move each counter named in ``delta`` by its value."""
    _counts.update(delta)


def reset_counts(to=None):
    """Set every counter to 0, or to its value in ``to`` (a ``counts()``)."""
    _counts.clear()
    if to:
        _counts.update(to)
