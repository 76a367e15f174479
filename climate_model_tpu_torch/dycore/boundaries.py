"""Boundary-condition shift primitives (single device).

Port of the single-device half of ``climate_model_tpu/dycore/boundaries.py``.
There is no allocated halo: operators are written against these global-array
neighbor shifts. Axis -1 is longitude (periodic), axis -2 latitude (rigid
walls). Shifts are named by the SOURCE of the data:
``west(a)[..., i] = a[..., i-1]``. The shard-aware mode of the reference
(``_ShardCtx``/``shard_mode``) comes with the distributed slice.
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
    return torch.cat([torch.zeros_like(a[..., :1, :]), a[..., :-1, :]], dim=-2)


def north_zero(a):
    """Value of the north (j+1) neighbor; zero beyond the north wall."""
    return torch.cat([a[..., 1:, :], torch.zeros_like(a[..., -1:, :])], dim=-2)


def south_clamp(a):
    """South neighbor with edge replication (zero-gradient wall)."""
    return torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)


def north_clamp(a):
    """North neighbor with edge replication (zero-gradient wall)."""
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


def enforce_v_walls(v):
    """Zero the stored south-wall row of v (the north wall row is not
    stored). Returns a new tensor."""
    out = v.clone()
    out[..., 0, :] = 0.0
    return out
