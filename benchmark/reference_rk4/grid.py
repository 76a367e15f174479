"""The frozen reference's grid (``reference/grid.py``)."""

from ..reference.grid import make_grid  # noqa: F401
