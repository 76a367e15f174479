"""The frozen reference's configuration (``reference/config.py``)."""

from ..reference.config import config_from_dict  # noqa: F401
