"""The frozen reference's grid (``reference/grid.py``)."""

from benchmark.reference.grid import make_grid  # noqa: F401
