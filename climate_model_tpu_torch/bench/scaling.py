"""Scaling harness: the 1x1 grid against the same grid on its mesh.

Port of ``climate_model_tpu/bench/scaling.py``: the chunk runner on one
device (``make_chunk_runner`` of the config with a 1x1 mesh) against the
same grid on the config's mesh, each the best of ``repeats`` runs of
``steps`` steps from the same state, between two synchronizes. It reports
efficiency = (gps_N / gps_1) / N and the ratio gps_N / gps_1. On the mesh,
as the reference dispatches (``:53-67``): ``backend='pallas'`` with
``mode='shard_map'`` runs the sharded packed scan (``dist/packed_halo.py``),
``backend='jnp'`` with ``shard_map`` the per-operator halo path
(``dist/halo.py``), and ``mode='auto'`` the plain backend's GSPMD ``auto``
path whatever the config's backend (the reference's ``cfgn``).

Where the mesh's shards share one card (no ``torch.distributed`` process
group: every shard in this process), the metric names it, as the run's
start line does, and ``gps_ratio`` is the figure that means something: it
isolates the cost of the decomposition on shared hardware. In one process
``auto`` runs the global program on the one device (``dist/halo.py``), and
its metric says so.
"""

from __future__ import annotations

import dataclasses
import time

from ..core.config import ModelConfig
from ..core.init import initialize
from ..dist import halo
from ..dist.mesh import make_mesh, validate_divisibility
from ..dist.sharding import Halo, shard
from ..model import make_chunk_runner
from .micro import sync


def _time_run(run, *args, device, steps, repeats=3):
    """Best wall seconds a step of ``run(*args)`` over ``repeats`` runs
    after a warm one, each between two synchronizes on a card."""
    run(*args)
    best = float("inf")
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        run(*args)
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best / steps


def measure_scaling(cfg: ModelConfig, steps: int = 10,
                    mode: str = "shard_map", device="cuda") -> dict:
    """Time 1-device vs full-mesh runs of cfg's grid; returns gps and
    efficiency."""
    gc = cfg.grid
    npts = gc.nx * gc.ny * gc.nz
    n_dev = cfg.sharding.mesh_lat * cfg.sharding.mesh_lon

    cfg1 = cfg.replace(sharding=dataclasses.replace(cfg.sharding,
                                                    mesh_lat=1, mesh_lon=1))
    state, forcing, grid = initialize(cfg1, device=device)
    dev = state.device
    t1 = _time_run(make_chunk_runner(cfg1, steps), state, grid, forcing,
                   device=dev, steps=steps)

    use_pallas = cfg.backend == "pallas" and mode == "shard_map"
    cfgn = cfg if use_pallas else cfg.replace(
        backend="jnp", sharding=dataclasses.replace(cfg.sharding, mode=mode))
    mesh = make_mesh(cfgn, device=dev)
    validate_divisibility(cfgn, mesh)
    if use_pallas:
        where, sn = mesh.describe(), shard(mesh, state, grid, forcing, Halo())
    else:
        where = halo.describe(cfgn, mesh)
        sn = shard(mesh, state, grid, forcing, halo.NO_HALO) \
            if halo.takes_blocks(cfgn, mesh) else state
    tn = _time_run(make_chunk_runner(cfgn, steps), sn, grid, forcing,
                   device=dev, steps=steps)

    gps1, gpsn = npts / t1, npts / tn
    eff = (gpsn / gps1) / n_dev
    return {
        "metric": f"scaling efficiency 1->{n_dev} devices "
                  f"({gc.nx}x{gc.ny}x{gc.nz}, {mode}; {where})",
        "value": round(eff, 4),
        "unit": "fraction",
        "vs_baseline": round(eff / 0.80, 4),   # BASELINE target: >= 0.80
        "gps_1dev": round(gps1, 1),
        "gps_ndev": round(gpsn, 1),
        # N-device / 1-device throughput; with the shards on one card,
        # ``value`` (which divides by N) means little, and this isolates
        # the decomposition's cost (1.0 = it costs nothing)
        "gps_ratio": round(gpsn / gps1, 4),
        "n_devices": n_dev,
    }
