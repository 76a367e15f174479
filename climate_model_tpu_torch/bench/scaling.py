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

On a card the packed scan's runs, 1x1 and on the mesh, are the compiled
chunk (``graphs.py``); ``graphs`` names the mesh run's, and
``host_ms_per_step`` is its host's time a step to enqueue the best run.

Across ranks (``bench --scaling --multihost``: one shard per rank, a card
each under NCCL), rank 0 times the 1x1 grid on its card while the other
ranks wait at a barrier; then every rank times the mesh, each run started
at a barrier, and a run's time is the slowest rank's. Every rank returns
the same result; the metric names the ranks and their backend.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as tdist

from ..core.config import ModelConfig
from ..core.init import initialize
from ..dist import halo
from ..dist.mesh import (barrier, in_process_group, make_mesh,
                         validate_divisibility)
from ..dist.sharding import Halo, shard
from ..model import make_chunk_runner, takes_graphs
from .micro import sync


def _time_run(run, *args, device, steps, repeats=3, ranks=False):
    """Best wall seconds a step of ``run(*args)`` over ``repeats`` runs
    after a warm one, each between two synchronizes on a card, and the
    host's seconds a step to enqueue that run (to ``run``'s return). With
    ``ranks``, every rank of the process group runs it: each run starts at
    a barrier, and the result is the slowest rank's best, and its
    slowest host."""
    run(*args)
    best, best_host = float("inf"), None
    for _ in range(repeats):
        sync(device)
        if ranks:
            barrier(device)
        t0 = time.perf_counter()
        run(*args)
        host = time.perf_counter() - t0
        sync(device)
        wall = time.perf_counter() - t0
        if wall < best:
            best, best_host = wall, host
    if ranks:
        t = torch.tensor([best, best_host], dtype=torch.float64,
                         device=device)
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
        best, best_host = (float(x) for x in t)
    return best / steps, best_host / steps


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
    ranks = in_process_group()
    t1 = None
    if not ranks or tdist.get_rank() == 0:
        t1, _ = _time_run(make_chunk_runner(cfg1, steps), state, grid,
                          forcing, device=dev, steps=steps)
    if ranks:
        # the other ranks wait here while rank 0 times the 1x1 grid
        box = [t1]
        tdist.broadcast_object_list(box, src=0, device=dev)
        t1 = box[0]

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
    tn, host_n = _time_run(make_chunk_runner(cfgn, steps), sn, grid,
                           forcing, device=dev, steps=steps,
                           ranks=mesh.distributed)

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
        # the mesh run: through the compiled chunk (graphs.py), and the
        # host's ms a step to enqueue it
        "graphs": takes_graphs(cfgn, dev),
        "host_ms_per_step": round(host_n * 1e3, 4),
    }
