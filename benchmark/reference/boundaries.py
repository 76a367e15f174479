"""Frozen copy of ``climate_model_tpu_torch/dycore/boundaries.py`` at commit
dbbffa0, one device only (the port's shard mode left out): the benchmark's
plain reference imports nothing of the port.

Boundary-condition shift primitives. Axis -1 is longitude (periodic), axis
-2 latitude (rigid walls). Shifts are named by the SOURCE of the data:
``west(a)[..., i] = a[..., i-1]``.
"""

from __future__ import annotations

import torch


def west(a):
    """Value of the west (i-1) neighbor; periodic wrap at the lon seam."""
    return torch.roll(a, 1, dims=-1)


def east(a):
    """Value of the east (i+1) neighbor; periodic wrap at the lon seam."""
    return torch.roll(a, -1, dims=-1)


def south_zero(a):
    """Value of the south (j-1) neighbor; zero beyond the south wall."""
    return torch.cat([torch.zeros_like(a[..., :1, :]), a[..., :-1, :]],
                     dim=-2)


def north_zero(a):
    """Value of the north (j+1) neighbor; zero beyond the north wall."""
    return torch.cat([a[..., 1:, :], torch.zeros_like(a[..., -1:, :])],
                     dim=-2)


def south_clamp(a):
    """South neighbor with edge replication (zero-gradient wall)."""
    return torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)


def north_clamp(a):
    """North neighbor with edge replication (zero-gradient wall)."""
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


def enforce_v_walls(v):
    """Zero the stored south-wall row of v (the north wall row is not
    stored)."""
    return torch.cat([torch.zeros_like(v[..., :1, :]), v[..., 1:, :]],
                     dim=-2)
