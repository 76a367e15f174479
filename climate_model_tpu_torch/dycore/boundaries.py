"""Boundary-condition shift primitives.

Port of ``climate_model_tpu/dycore/boundaries.py``. There is no allocated
halo: operators are written against these global-array neighbor shifts.
Axis -1 is longitude (periodic), axis -2 latitude (rigid walls). Shifts are
named by the SOURCE of the data: ``west(a)[..., i] = a[..., i-1]``.

**Shard mode** (``shard_mode``, set by ``dist/halo.py`` around one shard's
run): each shift fetches its one-cell halo from the neighbouring shard
through an edge exchanger of ``dist/comm.py`` (the reference's
``ppermute``). In longitude the shards form a periodic ring; in latitude an
open chain whose ends get zeros (``*_zero``) or the block's own edge row
(``*_clamp``); only the southernmost shard holds the v wall row. A mesh axis
of extent 1 keeps the local ``roll``/``cat``. The reference switches a
global context while it traces one ``shard_map`` body; here the shards of
one process run at once, one thread each, so the context is thread-local.
The reference's trace-time dedup of identical shifts (``_cached``) saves
collectives in a traced program and changes no number; eager PyTorch has no
trace to dedup within, so every shift exchanges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch


@dataclasses.dataclass(frozen=True)
class _ShardCtx:
    """The shard this thread runs, and where its halos come from."""

    edges: object = None     # dist.comm edge exchanger; None: one device
    shard: int = 0
    lat_idx: int = 0
    n_lat: int = 1           # mesh extent along each axis
    n_lon: int = 1


_NONE = _ShardCtx()
_LOCAL = threading.local()


def _ctx() -> _ShardCtx:
    return getattr(_LOCAL, "ctx", _NONE)


@contextlib.contextmanager
def shard_mode(edges, shard: int):
    """Switch this thread's shift primitives to shard-local semantics for
    ``shard`` of ``edges.mesh``: each shift posts the edge slab its
    neighbour needs and returns the one the neighbour posted."""
    mesh = edges.mesh
    prev = _ctx()
    _LOCAL.ctx = _ShardCtx(edges=edges, shard=shard,
                           lat_idx=mesh.index(shard)[0],
                           n_lat=mesh.n_lat, n_lon=mesh.n_lon)
    try:
        yield
    finally:
        _LOCAL.ctx = prev


def _halo(ctx: _ShardCtx, op: str, side: str, a, slab):
    """The neighbour on ``side``'s ``slab`` of the same shift (None past a
    chain end), having posted this shard's ``slab``."""
    return ctx.edges.swap(ctx.shard, (op, tuple(a.shape)), side, slab)


def west(a):
    """Value of the west (i-1) neighbor; periodic wrap at the lon seam."""
    ctx = _ctx()
    if ctx.n_lon == 1:
        return torch.roll(a, 1, dims=-1)
    recv = _halo(ctx, "west", "west", a, a[..., -1:])
    return torch.cat([recv, a[..., :-1]], dim=-1)


def east(a):
    """Value of the east (i+1) neighbor; periodic wrap at the lon seam."""
    ctx = _ctx()
    if ctx.n_lon == 1:
        return torch.roll(a, -1, dims=-1)
    recv = _halo(ctx, "east", "east", a, a[..., :1])
    return torch.cat([a[..., 1:], recv], dim=-1)


def _from_south(ctx, op, a):
    """The north row of the south neighbour's block (None on the
    southernmost shard)."""
    return _halo(ctx, op, "south", a, a[..., -1:, :])


def _from_north(ctx, op, a):
    return _halo(ctx, op, "north", a, a[..., :1, :])


def south_zero(a):
    """Value of the south (j-1) neighbor; zero beyond the south wall."""
    ctx = _ctx()
    recv = None if ctx.n_lat == 1 else _from_south(ctx, "south_zero", a)
    if recv is None:
        recv = torch.zeros_like(a[..., :1, :])
    return torch.cat([recv, a[..., :-1, :]], dim=-2)


def north_zero(a):
    """Value of the north (j+1) neighbor; zero beyond the north wall."""
    ctx = _ctx()
    recv = None if ctx.n_lat == 1 else _from_north(ctx, "north_zero", a)
    if recv is None:
        recv = torch.zeros_like(a[..., -1:, :])
    return torch.cat([a[..., 1:, :], recv], dim=-2)


def south_clamp(a):
    """South neighbor with edge replication (zero-gradient wall)."""
    ctx = _ctx()
    recv = None if ctx.n_lat == 1 else _from_south(ctx, "south_clamp", a)
    if recv is None:
        recv = a[..., :1, :]
    return torch.cat([recv, a[..., :-1, :]], dim=-2)


def north_clamp(a):
    """North neighbor with edge replication (zero-gradient wall)."""
    ctx = _ctx()
    recv = None if ctx.n_lat == 1 else _from_north(ctx, "north_clamp", a)
    if recv is None:
        recv = a[..., -1:, :]
    return torch.cat([a[..., 1:, :], recv], dim=-2)


def enforce_v_walls(v):
    """Zero the stored south-wall row of v (the north wall row is not
    stored). Under shard mode only the southernmost lat shard holds it.
    Out of place (a ``cat``, not a row write), so that it also runs on the
    DTensors of the ``auto`` mode (``dist/sharding.py``)."""
    if _ctx().lat_idx != 0:
        return v
    return torch.cat([torch.zeros_like(v[..., :1, :]), v[..., 1:, :]],
                     dim=-2)
