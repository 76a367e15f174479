"""Profiling harness: per-subsystem step time and share, and a trace.

Port of ``climate_model_tpu/bench/profile.py``. For ``backend='pallas'``
(the packed scan) the subsystems are its kernels, timed on the device by
``bench/micro.py``: surface, turbulence and microphysics run inside the
corrector's epilogue, so timing the plain splits would describe code that
path never runs. Otherwise each split is timed alone: the best of
``repeats`` calls, each between two synchronizes. ``trace_dir`` writes a
``torch.profiler`` Chrome trace of one dynamics step (``trace.json``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ..core.config import ModelConfig
from ..core.init import initialize
from ..dycore.stepper import dynamics_step_fn
from ..physics.microphysics import microphysics_step
from ..physics.radiation import compute_radiation
from ..physics.surface import surface_step
from ..physics.turbulence import turbulence_step
from .micro import sync


def _time(fn, *args, device, repeats=5):
    """(best wall s, output) of ``fn(*args)`` over ``repeats`` calls after a
    warm one, each between two synchronizes on a card."""
    out = fn(*args)
    best = float("inf")
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def profile_subsystems(cfg: ModelConfig, trace_dir: Optional[str] = None,
                       quiet: bool = False, device="cuda") -> dict:
    """Per-subsystem best step time [s] and share of the total. Optionally
    writes a profiler trace of one dynamics step."""
    if cfg.backend == "pallas":
        from .micro import micro_bench
        rep = micro_bench(cfg=cfg, iters=50, device=device)
        rows = {"predictor_kernel": rep["pred_ms"] / 1e3,
                "corrector_kernel(+physics epilogue)": rep["corr_ms"] / 1e3}
        total = rows["predictor_kernel"] + \
            rows["corrector_kernel(+physics epilogue)"]
        if "rad_ms" in rep:
            rows["radiation"] = rep["rad_ms"] / 1e3
            rows["radiation_amortized"] = \
                rep["rad_ms"] / 1e3 / max(rep["rad_every_steps"], 1)
            total += rows["radiation_amortized"]
        rows["total_per_step"] = total
        if not quiet:
            print(f"{'kernel':<38}{'ms/step':>10}  {'share':>6}")
            for k, v in rows.items():
                if k in ("total_per_step", "radiation"):
                    continue
                print(f"{k:<38}{v*1e3:>10.3f}  {v/total*100:>5.1f}%")
            print(f"{'total_per_step':<38}{total*1e3:>10.3f}")
            print("(micro detail on {device}: vs-bytes pred {pred_vs_bytes}x "
                  "corr {corr_vs_bytes}x)".format(**rep))
        return rows

    state, forcing, grid = initialize(cfg, device=device)
    dev, dt = state.device, grid.dt
    rows = {}

    dyn = dynamics_step_fn(cfg)
    rows["dynamics"], _ = _time(dyn, state, grid, forcing, device=dev)

    p = cfg.physics
    if p.radiation:
        rows["radiation"], _ = _time(
            lambda s: compute_radiation(s, grid, forcing, cfg), state,
            device=dev)
        rows["radiation_amortized"] = rows["radiation"] / max(
            p.rad_every_steps, 1)
    if p.surface:
        rows["surface"], _ = _time(
            lambda s: surface_step(s, grid, forcing, cfg, dt), state,
            device=dev)
    if p.turbulence:
        rows["turbulence"], _ = _time(
            lambda s: turbulence_step(s, grid, forcing, cfg, dt), state,
            device=dev)
    if p.microphysics:
        rows["microphysics"], _ = _time(
            lambda s: microphysics_step(s, grid, forcing, cfg, dt), state,
            device=dev)

    total = rows["dynamics"] + sum(
        v for k, v in rows.items()
        if k in ("radiation_amortized", "surface", "turbulence",
                 "microphysics"))
    rows["total_per_step"] = total

    if trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            dyn(state, grid, forcing)
            sync(dev)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        rows["trace_dir"] = trace_dir

    if not quiet:
        print(f"{'subsystem':<22}{'ms/step':>10}  {'share':>6}")
        for k, v in rows.items():
            if isinstance(v, float) and k != "total_per_step":
                if k == "radiation":    # raw per-call cost; the amortized
                    share = "     —"    # row below carries the step share
                else:
                    share = f"{v / total * 100:>5.1f}%"
                print(f"{k:<22}{v*1e3:>10.3f}  {share}")
        print(f"{'total_per_step':<22}{total*1e3:>10.3f}")
    return rows
