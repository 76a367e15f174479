"""The frozen reference's initial state (``reference/init.py``)."""

from benchmark.reference.init import initial_state_np  # noqa: F401
