"""Per-kernel micro-benchmark: chained launches timed on the device.

Port of ``climate_model_tpu/bench/micro.py``. Each kernel (the masked
predictor, the corrector with the physics epilogue) and the radiation step
at ``rad_every_steps=1`` is chained, its output fed back as its next input,
as the reference chains them in a ``lax.scan``. On the card the chain's
launches are queued behind a sleep kernel and timed with CUDA events, so
that the device time carries no host gap (``device_ms``); on the CPU the
host clock is the device's.

Each kernel is set beside its byte floor (``bench/roofline.py::
substep_work``'s bytes, each input read once and each output written once,
over the card's memory rate) and the launch plan of its shape
(``kernels/fused_substep.py::launch_plan``). The reference's Mosaic keys
(tile rows, DMA floors, VPU ops a tile) have no counterpart here.

``device_ms`` and ``launch_ms`` are also the clock of ``chip_smoke.py``'s
kernel table.

Usage: python -m climate_model_tpu_torch bench --micro [--baseline 3]
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core.config import ModelConfig, baseline_config
from ..core.init import initialize
from .roofline import card_name, device_hbm_bw, substep_work


def sync(device):
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, n=50, warmup=5) -> tuple:
    """(device ms, host ms) per call of ``fn`` on the card. The device time
    is that of ``n`` calls' launches back to back on the stream: a sleep
    kernel holds the stream while the host enqueues them, so the events
    between the sleep and the last call see no host gap. The host time is
    that of ``n`` calls in a loop. A gap shows as the sleep's end reached
    before the host is done: a host slower than the sleep, or more launches
    than the device's queue holds (the plain versions launch hundreds of
    kernels a call); then fewer calls are timed, down to one, and a gap
    there refuses the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = 1e3 * (time.perf_counter() - h0) / n
    torch.cuda.synchronize()
    c0, c1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    c0.record()
    torch.cuda._sleep(1_000_000)
    c1.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / c0.elapsed_time(c1)
    while True:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int((2.0 * host_ms * n + 5.0) * cycles_per_ms))
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        gap = e0.query()           # the sleep ended before the host was done
        torch.cuda.synchronize()
        if not gap:
            return e0.elapsed_time(e1) / n, host_ms
        if n == 1:
            raise AssertionError("device time not separable from the "
                                 "host's: the stream ran dry during one call")
        n = max(1, n // 5)


# The kernels' launches by the name the profiler gives them, and the short
# name of each in the ``launch_ms`` split.
LAUNCH_NAMES = (("substep_kernel", "substep"),
                ("epilogue_kernel", "epilogue"))


def launch_ms(fn, n=20, warmup=3):
    """Device ms per call of each kernel launch of ``fn``, by launch
    (``LAUNCH_NAMES``): the CUDA activity that ``torch.profiler`` records
    over ``n`` calls, summed per kernel and divided by ``n``. None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = next((getattr(ev, a) for a in ("self_device_time_total",
                                            "self_cuda_time_total")
                   if getattr(ev, a, None)), 0.0)
        for key, short in LAUNCH_NAMES:
            if key in ev.key and us:
                split[short] = split.get(short, 0.0) + us / 1e3 / n
    return split or None


def _chain_ms(fn, init, iters: int, device) -> float:
    """ms per link of the chain ``x -> fn(x)`` from ``init``: device time on
    the card (``device_ms``), the best of 3 host-clock runs on the CPU."""
    box = [init]

    def link():
        box[0] = fn(box[0])

    if device.type == "cuda":
        return device_ms(link, n=iters)[0]
    link()                                   # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            link()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best / iters


def micro_bench(baseline: int = 3, iters: int = 200,
                dtype: str = "float32", cfg: ModelConfig = None,
                device="cuda") -> dict:
    """Device ms per call of the masked predictor, the corrector with the
    physics epilogue and the radiation step (every step) at the shapes of
    ``cfg`` (default: BASELINE ``baseline`` with ``backend='pallas'``), each
    chained ``iters`` times; on a CPU ``device`` the plain versions."""
    from ..kernels.fused_substep import (corrector, launch_plan, predictor,
                                         wall_mask)
    from ..model import phys_epilogue_tuple
    from ..physics.radiation import radiation_step

    if cfg is None:
        cfg = baseline_config(baseline).replace(dtype=dtype,
                                                backend="pallas")
    gc, num, phys = cfg.grid, cfg.numerics, cfg.physics
    nz, ny, nx = gc.nz, gc.ny, gc.nx
    state, forcing, grid = initialize(cfg, device=device)
    dev, dt = state.device, grid.dt
    phys_tuple = phys_epilogue_tuple(cfg)
    kw = dict(with_rad=phys.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    vm = wall_mask(ny, state.dtype, dev)

    def pred(s):
        return predictor(s, grid, forcing, dt, vmask=vm, **kw)

    def corr(s):
        return corrector(s, s, grid, forcing, dt, phys=phys_tuple, vmask=vm,
                         **kw)

    bw = device_hbm_bw(dev)
    p0 = pred(state)
    pred_floor = 1e3 * substep_work(state, None, grid, forcing, p0,
                                    vmask=vm)[0] / bw
    corr_floor = 1e3 * substep_work(state, state, grid, forcing, corr(state),
                                    phys=phys_tuple, vmask=vm)[0] / bw
    t_pred = _chain_ms(pred, state, iters, dev)
    t_corr = _chain_ms(corr, state, iters, dev)
    plan = launch_plan(nz, ny, nx)
    rep = {
        "config": f"{nx}x{ny}x{nz}", "dtype": cfg.dtype,
        "device": card_name(dev),
        "plan": {part: {"tile": [tp.tx, tp.tj], "grid": list(tp.grid),
                        "smem_bytes": tp.smem_bytes}
                 for part, tp in (("substep", plan.substep),
                                  ("epilogue", plan.epilogue))},
        "pred_ms": round(t_pred, 4),
        "corr_ms": round(t_corr, 4),
        "pred_bytes_floor_ms": round(pred_floor, 5),
        "corr_bytes_floor_ms": round(corr_floor, 5),
        "pred_vs_bytes": round(t_pred / pred_floor, 2),
        "corr_vs_bytes": round(t_corr / corr_floor, 2),
    }
    if phys.radiation:
        cfg1 = cfg.replace(physics=dataclasses.replace(phys,
                                                       rad_every_steps=1))
        t_rad = _chain_ms(lambda s: radiation_step(s, grid, forcing, cfg1),
                          state, iters, dev)
        rep["rad_ms"] = round(t_rad, 4)
        rep["rad_every_steps"] = phys.rad_every_steps
        rep["step_model_ms"] = round(
            t_pred + t_corr + t_rad / max(phys.rad_every_steps, 1), 4)
    return rep
