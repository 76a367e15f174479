"""The frozen reference's initial state (``reference/init.py``)."""

from ..reference.init import initial_state_np  # noqa: F401
