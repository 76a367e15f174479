"""Chip smoke test of the PyTorch/CUDA port (climate_model_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds; any failure raises
and exits non-zero:

1. device   -- a CUDA device or raise; its name, count and power limit;
2. build    -- every kernel built from csrc/ with one nvcc call; the
               -Xptxas -v register, shared-memory and spill lines of each;
3. check    -- BASELINE config #3 (360x180x32, fp32, full physics), 10
               plain steps from the initial state. Each kernel variant is
               held against its plain version on the same inputs, field by
               field, within the stated bounds: the predictor and corrector
               (v wall by row index), the predictor with the wall mask and
               the corrector with the mask and the physics epilogue (from
               the same state with its moisture raised near saturation from
               a seed, so that every physics term is active; also with
               convection on). The mask variants must equal the index rule
               bit for bit, and a mask with an interior row set to 0 must
               zero v there. Planted faults: each kernel launched with one
               term left out must break a bound in one call; without
               diffusion, from the state with grid-scale noise, the bound
               of each diffused field;
4. timing   -- device time of each variant and its plain version, in
               turns (CUDA events over launches queued behind a sleep
               kernel, so that no host gap enters), with the host's time
               per call beside it, against the bound of the card; the
               device time of each launch of a call apart (the substep,
               the epilogue), from torch.profiler;
5. main     -- the run command of config #3 (``run --baseline 3 --days 0.1
               --out-every-hours 1``: 253 steps in three chunks, adaptive
               dt, hourly radiation), which takes the packed scan, with
               every launch and call counter set to 0 just before and read
               just after: one masked predictor and one epilogue corrector
               a step, no other launch and no plain physics split; cadence,
               dt and fields are checked. No file is written;
6. per-step -- the per-step path (``run_scan(make_step_fn(cfg), ...)``) for
               the first chunk of the run, from the same initial state,
               with its counters and sanity checks; the packed scan over
               the same steps, compared with it field by field; ms/step of
               both paths, in turns;
7. breakdown -- each layer of a step timed alone; the host's enqueue time
               of a packed-scan step against its device time;
8. sharded  -- BASELINE #4 (720x360x32) on its 2x4 mesh, 8 shards on the
               card: ``run --baseline 4 --days 0.05 --halo-overlap`` with
               every counter set to 0 just before and read just after (8
               shard launches of each program a step, 4 south-strip and 4
               north-strip), then the blocking schedule and the unsharded
               grid (``--mesh-lat 1 --mesh-lon 1``); each pair compared per
               field (SHARDED_TOL) and bit for bit. Then FAULT_STEPS steps
               from a noisy #4 state: the sound sharded run and each planted
               fault (the lon exchange left out, the lat exchange left out,
               ghosts of 2) against the unsharded grid;
9. backend  -- ``run --baseline 1`` (backend='jnp') on the card: the plain
               path, no kernel launch, finite fields;
10. io      -- in a temporary directory that it removes: phase 5's run
               with ``--out-dir`` (the NetCDF files, metrics.jsonl and the
               checkpoint read back and held against the final state, and
               ms/step with output beside phase 5's); the same horizon run
               in two parts across a checkpoint, equal to it bit for bit
               in every State field, with one metrics timeline and the same
               last NetCDF file; planted faults (a resume with the
               radiation cache zeroed must differ, a resume with ``--diff``
               changed must be refused naming the field, and with
               ``--force-resume`` must record the branch); #4's blocking
               run on its 2x4 mesh in two parts, the checkpoint saved from
               the gathered state, equal to the continuous run bit for bit;
               the host ms of save_checkpoint, load_checkpoint and
               NCWriter.write. It prints whether matplotlib imports, which
               gates nothing.

Phase 3 also holds the epilogue's momentum terms on a windy state
(MOMENTUM_FAULTS), the epilogue on TALL_NZ levels, and the shard-local and
seam-strip variants on blocks of the noisy #4 state (CHECK_BLOCKS); phase 4
times those variants at #4's 2x4 shapes. The line before last is the total,
the last line the JSON verdict. The port
imports no JAX, and neither does this script.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from climate_model_tpu_torch import cli
from climate_model_tpu_torch.core.config import (baseline_config,
                                                 resolve_rad_interval)
from climate_model_tpu_torch.core.grid import adaptive_cfl_dt, round_to
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.dist import sharding
from climate_model_tpu_torch.dist.mesh import Mesh, make_mesh
from climate_model_tpu_torch.dist.packed_halo import SeamStrip, row_mask
from climate_model_tpu_torch.dycore.operators import diagnose_pressure
from climate_model_tpu_torch.dycore.stepper import run_scan, step_matsuno
from climate_model_tpu_torch.io.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
from climate_model_tpu_torch.io.netcdf import NCWriter
from climate_model_tpu_torch.kernels import fused_substep as fs
from climate_model_tpu_torch.model import (make_chunk_runner, make_step_fn,
                                           phys_epilogue_tuple)
from climate_model_tpu_torch.physics import (microphysics, radiation,
                                             surface, turbulence)
from climate_model_tpu_torch.physics.thermo import qsat_water

MAIN_ARGV = ["run", "--baseline", "3", "--days", "0.1",
             "--out-every-hours", "1"]

# Per-field bounds on max|kernel - plain| for ONE substep at config #3 in
# fp32, from the state 10 plain steps in. The kernel and the plain version
# differ only by fp32 rounding in another order (FMA contraction, sequential
# k-sums). Each bound is 2.5-4x the largest error measured on an H100 (u
# 1.3e-4 m/s, v 3.2e-5 m/s, pott 6.1e-5 K (2 ulp at 300 K), qv 1.4e-9, qc 0,
# colp 7.8e-3 Pa (1 ulp at 9e4 Pa)), and well below what one term of the
# substep adds in one step: phase 3 launches the kernel with the radiative
# source left out, then with diffusion left out, and requires each to
# break a bound (PLANTED_FAULTS). The same bounds hold one substep from the
# state with grid-scale noise (rough_state), where the kernel without
# diffusion must break the bound of each of DIFFUSED.
FIELD_TOL = {"u": 5e-4, "v": 1e-4, "pott": 1.5e-4, "qv": 5e-9, "qc": 1e-10,
             "colp": 0.03}
PLANTED_FAULTS = {"with_rad=False": {"with_rad": False},
                  "with_diff=False": {"with_diff": False}}
DIFFUSED = ("u", "v", "pott", "qv")

# Per-field bounds on max|kernel - plain| for ONE call of the corrector with
# the physics epilogue at config #3 in fp32, from the moist check state
# (moist_state). Each is 3.0-3.8x the error measured on an H100 (u 1.26e-4
# m/s, v 3.09e-5 m/s, pott 7.9e-4 K, qv 3.08e-7, qc 2.99e-7, colp 7.8e-3
# Pa, tsurf 3.05e-5 K, rain 6.6e-6 kg/m2, soil_moist 4.7e-9 m). pott and
# the moisture carry the saturation adjustment's sensitivity to the Exner
# factor of the new colp, a difference of two nearly equal fp32 products
# rounded in another order (FMA). One call suffices for the planted faults:
# the epilogue without the surface, the turbulence or the microphysics each
# breaks a bound (EPI_FAULTS).
EPI_TOL = {"u": 4e-4, "v": 1e-4, "pott": 2.5e-3, "qv": 1e-6, "qc": 1e-6,
           "colp": 0.03, "tsurf": 1e-4, "rain": 2e-5, "soil_moist": 1.5e-8}
EPI_FAULTS = ("surface", "turbulence", "microphysics")
# Bounds on max|packed scan - per-step path| after the first chunk (105
# steps) from the initial state: the same model, the epilogue kernel in
# place of the plain physics splits. 3.0-3.6x the difference measured on an
# H100 (u 1.87e-3 m/s, v 1.95e-3 m/s, pott 7.6e-4 K, qv 9.8e-8, colp 8.6e-2
# Pa, tsurf 1.22e-4 K, soil_moist 2.8e-9 m; qc and rain 0: the run's air
# stays below saturation for its first hour).
PATHS_TOL = {"u": 6e-3, "v": 6e-3, "pott": 2.5e-3, "qv": 3e-7, "qc": 1e-10,
             "colp": 0.3, "tsurf": 4e-4, "rain": 1e-10, "soil_moist": 1e-8}
SEED = 5                         # the generator of the check states

# The epilogue's momentum terms (surface drag and K-diffusion of u and v)
# are read on a state with strong winds near the surface and vertical shear
# (windy_state): without the surface, and without the turbulence, u and v
# must each break their EPI_TOL bound in one call, and the sound kernel
# must stay within every bound.
MOMENTUM_FAULTS = ("surface", "turbulence")
# A column taller than one warp's lanes (three levels a lane): config #3's
# physics on a small grid with TALL_NZ levels, from the moist state. With
# layers 3x thinner, the Exner factor's difference of two nearly equal
# products (see EPI_TOL) loses 3x more to rounding: an H100 read pott
# 3.05e-3 K, qv 1.42e-6, qc 1.07e-6, rain 5.20e-5, soil_moist 2.33e-8 (u
# 7.8e-5, v 3.6e-5, tsurf 3.05e-5, colp 0). TALL_TOL is 3.3-4.7x these
# and EPI_TOL's bounds elsewhere.
TALL_NZ = 96
TALL_GRID = (64, 32)             # nx, ny
TALL_TOL = dict(EPI_TOL, pott=1e-2, qv=5e-6, qc=5e-6, rain=2e-4,
                soil_moist=1e-7)

# BASELINE #4 (720x360x32, full physics, adaptive dt) on its 2x4 mesh,
# every shard on the one card: the halo-overlap schedule through the run
# command (the main path of this slice; the preset itself, as the
# reference's, leaves halo_overlap off), the blocking schedule, and the
# same grid unsharded (the 1x1 override), all from the initial state over
# 0.05 days (258 steps at 16.7 s, three chunks).
SHARDED_ARGV = ["run", "--baseline", "4", "--days", "0.05",
                "--out-every-hours", "0.4", "--halo-overlap"]
BLOCKING_ARGV = SHARDED_ARGV[:-1]
UNSHARDED_ARGV = BLOCKING_ARGV + ["--mesh-lat", "1", "--mesh-lon", "1"]
SHARD_PARTS = ("shard", "south_strip", "north_strip")
# The shard-local and seam-strip variants are checked on blocks cut from a
# #4-sized moist state with grid-scale noise: (name, mesh, shard).
CHECK_BLOCKS = (("interior", (4, 4), 5),      # ghosts on all four sides
                ("polar-edge", (2, 4), 1),    # the south wall, no ghosts
                ("lon-seam", (2, 4), 4))      # west ghosts across lon 0
# Bounds on max|kernel - plain| over the block's interior (a strip: the
# interior rows it keeps) for one call: the single-device bounds, which the
# same arithmetic keeps to (an H100 read at most u 1.34e-4, v 3.33e-5,
# pott 8.85e-4 with the epilogue, 6.1e-5 without, qv 3.48e-7, qc 3.41e-7,
# rain 3.56e-6), but for the predictor's qc: the check state has cloud
# water (the #3 check state has none there), and it read 1.164e-10, one
# ulp; its bound is 4.3x that.
SHARD_TOL = dict(FIELD_TOL, qc=5e-10)
SHARD_EPI_TOL = EPI_TOL
# Bounds on max|sharded run - unsharded run|, after the 258 steps of #4
# from the initial state and after FAULT_STEPS steps from the noisy #4
# check state (noisy4). An H100 read 0 in every field in both cases, both
# schedules: bit for bit, as the shard kernels do the same fp32 operations
# per point on the same values and radiation is column-local. Each bound
# is 3-6 fp32 ulp of the field's largest values, so a run passes only if
# it loses no more than the last bits of a few cells. Each planted fault
# (from the noisy state, where a fault at a seam is not lost to rounding)
# must break one, but for the lon exchange left out after the predictor
# only: that read 0 too, and is printed, not gated (PERF.md, Findings).
SHARDED_TOL = {"u": 2e-5, "v": 2e-5, "pott": 1e-4, "qv": 5e-9, "qc": 3e-10,
               "colp": 0.03, "tsurf": 1e-4, "rain": 5e-8,
               "soil_moist": 5e-8}
FAULT_STEPS = 20
# ... and BASELINE #1 (backend='jnp') on the card for 0.05 days: the plain
# per-step path, no kernel launch.
BACKEND_ARGV = ["run", "--baseline", "1", "--days", "0.05"]
# Phase 10 (io): config #3 with its files, continuous and split at half the
# horizon (step 127 of 253, between the radiation refreshes at steps 105
# and 210, so the resumed run needs the saved caches), and #4's blocking
# run on its 2x4 mesh split at half its horizon. Bit for bit equality holds
# because dt does not change across a resume: at these calm winds the
# adapted dt equals the initial dt in fp32, at #3 (34.148 s) and at #4
# (16.715 s).
IO_SPLIT_DAYS = 0.05
IO4_SPLIT_DAYS = 0.025
IO_TIMING_REPS = 3
NC_FIELDS = {"UWIND": "u", "VWIND": "v", "POTT": "pott", "QV": "qv",
             "QC": "qc", "COLP": "colp", "RAIN": "rain", "TSURF": "tsurf",
             "SOILMOIST": "soil_moist"}

# Main-path sanity bounds (the repo's verification recipe for a short run):
MAX_WIND = 100.0                 # m/s; beyond it the run is blowing up
MEAN_COLP = (90_000.0, 91_000.0)  # Pa, area-weighted mean COLP
POTT_RANGE = (280.0, 340.0)      # K, every cell
MASS_DRIFT = 1e-6                # relative drift of sum(colp*area)

# Card peaks for the bound (H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Floating-point operations per grid point, rounded up (an upper count:
# the bound is the bytes' at every shape run here). Substep: column scans
# incl. one powf per level ~35, three scalar advections ~135, two momentum
# equations ~140, face fluxes ~40. Epilogue (counting powf and expf as 20):
# up to three column profiles ~180, the five diffusions ~50, two face
# profiles ~16, microphysics ~80, the surface of three columns spread over
# the levels ~10, convective K (when on) ~70 -> 350 with it off.
FLOPS_PER_POINT = 350
EPILOGUE_FLOPS_PER_POINT = 350

STATE_FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
                "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc")

T0 = time.perf_counter()


def phase(name: str, t_start: float, msg: str = ""):
    print(f"[{name}] {time.perf_counter() - t_start:.2f}s {msg}".rstrip(),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A readable name of a kernel of csrc/ from its mangled one: the name
    and its template arguments (the substep's same_base, the epilogue's
    levels a lane)."""
    m = re.search(r"\d([a-z_]+_kernel)(.*)", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2).split("Ev", 1)[0])
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def ptxas_lines(log: str):
    """(kernel, lines) for each kernel in nvcc's -Xptxas -v output."""
    kernels, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = (kernel_name(line.split("'")[1]), [])
            kernels.append(cur)
        elif cur and ("registers" in line or "spill" in line
                      or "smem" in line or "stack frame" in line):
            cur[1].append(line.strip())
    return kernels


def timed(fn, n=50, warmup=5) -> float:
    """ms per call of ``fn`` over ``n`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def device_ms(fn, n=50, warmup=5) -> tuple:
    """(device ms, host ms) per call of ``fn``. The device time is that of
    ``n`` calls' launches back to back on the stream: a sleep kernel holds
    the stream while the host enqueues them, so the events between the
    sleep and the last call see no host gap. The host time is that of ``n``
    calls in a loop. A gap shows as the sleep's end reached before the host
    is done: a host slower than the sleep, or more launches than the
    device's queue holds (the plain versions launch hundreds of kernels a
    call); then fewer calls are timed, down to one, and a gap there
    refuses the time."""
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


def field_errors(got, want, tol) -> dict:
    """max|got - want| of each field in ``tol``; raises on a non-finite
    field of ``got``."""
    per = {}
    for f in tol:
        a, b = getattr(got, f), getattr(want, f)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {f} from the kernel")
        per[f] = float((a - b).abs().max())
    return per


def over(per: dict, tol: dict) -> list:
    return [f for f, e in per.items() if not e <= tol[f]]


def show(per: dict, tol: dict) -> str:
    bad = over(per, tol)
    return ", ".join(f"{f} {e:.3e}{' (over)' if f in bad else ''}"
                     f" (<= {tol[f]:.1e})" for f, e in per.items())


def bitwise_equal(a, b, fields=("u", "v", "pott", "qv", "qc", "colp")
                  ) -> bool:
    """Every field of ``a`` and ``b`` has the same bits."""
    return all(torch.equal(getattr(a, f).view(torch.int32),
                           getattr(b, f).view(torch.int32)) for f in fields)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def substep_bound_ms(ev, base, grid, forcing, out, phys=None, vmask=None):
    """Least time for one substep call: each input read once, each output
    written once, at the card's memory rate; or its operations at the fp32
    rate."""
    reads = [getattr(ev, f) for f in ("u", "v", "pott", "qv", "qc", "colp",
                                      "dpottdt_rad")]
    if base is not None:
        reads += [getattr(base, f) for f in ("u", "v", "pott", "qv", "qc",
                                             "colp")]
    reads += [forcing.hsurf, fs.geo_table(grid), grid.sigma_vb, grid.dsigma]
    writes = [getattr(out, f) for f in ("u", "v", "pott", "qv", "qc", "colp")]
    flops = FLOPS_PER_POINT
    if vmask is not None:
        reads.append(vmask)
    if phys is not None:
        reads += [getattr(base, f) for f in ("tsurf", "rain", "soil_moist",
                                             "swflx_sfc", "lwflx_sfc")]
        reads += [forcing.land_mask, forcing.evap_eff]
        writes += [out.tsurf, out.rain, out.soil_moist]
        flops += EPILOGUE_FLOPS_PER_POINT
    t_bytes = nbytes(*reads, *writes) / PEAK_BYTES_PER_S
    t_ops = flops * ev.u.numel() / PEAK_FP32_FLOPS
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def reset_counts():
    """Every launch counter of the kernels and call counter of the plain
    physics set to 0."""
    fs.reset_launch_counts()
    radiation.radiation_step.refreshes = 0
    surface.surface_step.calls = 0
    turbulence.turbulence_step.calls = 0
    microphysics.microphysics_step.calls = 0


def read_counts() -> dict:
    return {"predictor": fs.predictor.launches,
            "predictor_masked": fs.predictor.masked_launches,
            "corrector": fs.corrector.launches,
            "corrector_masked": fs.corrector.masked_launches,
            "corrector_epilogue": fs.corrector.epilogue_launches,
            **{f"{fn.__name__}_{part}": getattr(fn, f"{part}_launches")
               for fn in (fs.predictor, fs.corrector)
               for part in SHARD_PARTS},
            "radiation_refreshes": radiation.radiation_step.refreshes,
            "surface_split": surface.surface_step.calls,
            "turbulence_split": turbulence.turbulence_step.calls,
            "microphysics_split": microphysics.microphysics_step.calls}


def moist_state(state, grid, cfg, seed=SEED):
    """``state`` with moisture raised near saturation and the soil bucket
    spread between dry and field capacity, from a numpy generator: relative
    humidity 0.85-1.1 of the Magnus saturation at every level, cloud water
    around the autoconversion threshold. Every term of the epilogue is then
    active (condensation, evaporation of cloud, autoconversion and rain,
    convective mixing where it is on)."""
    r = np.random.default_rng(seed)
    kw = dict(dtype=state.dtype, device=state.device)
    pvb, pvtf, _ = diagnose_pressure(state.colp, grid)
    qs = qsat_water(state.pott * pvtf, 0.5 * (pvb[:-1] + pvb[1:]))
    rh = torch.as_tensor(r.uniform(0.85, 1.1, qs.shape), **kw)
    qc = torch.as_tensor(np.abs(r.normal(0.0, 2e-4, qs.shape)), **kw)
    soil = torch.as_tensor(r.uniform(0.0, cfg.physics.soil_moist_cap,
                                     state.colp.shape), **kw)
    return state.replace(qv=qs * rh, qc=qc, soil_moist=soil)


def rough_state(state, seed=SEED):
    """``state`` with grid-scale noise from a numpy generator: u and v
    +-1 m/s (v's wall row kept at 0), pott +-1 K, qv +-10 %. The horizontal
    diffusion of a smooth 1-degree field moves u, v and pott less in a step
    than fp32 rounding does; on this field it moves each of them far more,
    so a kernel that drops the diffusion of any one field shows."""
    r = np.random.default_rng(seed + 1)
    kw = dict(dtype=state.dtype, device=state.device)
    noise = lambda sd: torch.as_tensor(r.normal(0.0, sd, state.u.shape),
                                       **kw)
    v = state.v + noise(1.0)
    v[:, 0] = 0.0
    return state.replace(u=state.u + noise(1.0), v=v,
                         pott=state.pott + noise(1.0),
                         qv=state.qv * (1.0 + noise(0.1)).clamp(min=0.0))


@dataclasses.dataclass
class CheckInputs:
    cfg: object
    state: object       # 10 plain steps in
    moist: object       # the same with moisture near saturation
    rough: object       # the same with grid-scale noise
    grid: object
    forcing: object
    kw: dict            # with_rad, with_diff of the config
    phys: tuple         # the config's epilogue tuple
    vmask: torch.Tensor  # the single-device wall mask


def check_inputs(dev) -> CheckInputs:
    """Config #3 at full width, 10 plain steps from the initial state."""
    cfg = baseline_config(3)
    state, forcing, grid = initialize(cfg, device=dev)
    plain_step = make_step_fn(cfg, dynamics=functools.partial(step_matsuno,
                                                              cfg=cfg))
    for _ in range(10):
        state = plain_step(state, grid, forcing)
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    return CheckInputs(cfg=cfg, state=state,
                       moist=moist_state(state, grid, cfg),
                       rough=rough_state(state), grid=grid,
                       forcing=forcing, kw=kw, phys=phys_epilogue_tuple(cfg),
                       vmask=fs.wall_mask(grid.ny, torch.float32, dev))


def epilogue_args(ci: CheckInputs):
    """(ev, base, grid, forcing, dt) of the epilogue checks: the moist state
    and its plain masked prediction."""
    g, f, dt, s = ci.grid, ci.forcing, ci.grid.dt, ci.moist
    pred = fs.fused_substep_plain(s, None, g, f, dt, vmask=ci.vmask, **ci.kw)
    return pred, s, g, f, dt


def epilogue_pair(ci: CheckInputs, phys=None, vmask=None):
    """(kernel, plain) calls of the corrector with the physics epilogue on
    the moist state, evaluated at the plain masked prediction."""
    phys = ci.phys if phys is None else phys
    vmask = ci.vmask if vmask is None else vmask
    args = epilogue_args(ci)
    return (lambda: fs.corrector(*args, phys=phys, vmask=vmask, **ci.kw),
            lambda: fs.fused_substep_plain(*args, phys=phys, vmask=vmask,
                                           **ci.kw))


def phys_with(cfg, **switches) -> tuple:
    """The epilogue tuple of ``cfg`` with some physics switches changed."""
    return phys_epilogue_tuple(cfg.replace(physics=dataclasses.replace(
        cfg.physics, **switches)))


def check_kernels(ci: CheckInputs) -> dict:
    """Phase 3. Returns the errors of every variant; raises after printing
    every reading if any check failed."""
    g, f, dt = ci.grid, ci.forcing, ci.grid.dt
    st, kw = ci.state, ci.kw
    errs, bad = {}, []

    # -- predictor and corrector, v wall by index (the per-step path) --
    pred_plain = fs.fused_substep_plain(st, None, g, f, dt, **kw)
    corr_plain = fs.fused_substep_plain(pred_plain, st, g, f, dt, **kw)

    def launch(kname, **over):
        if kname == "predictor":
            return fs.predictor(st, g, f, dt, **dict(kw, **over))
        return fs.corrector(pred_plain, st, g, f, dt, **dict(kw, **over))

    want = {"predictor": pred_plain, "corrector": corr_plain}
    for kname in ("predictor", "corrector"):
        errs[kname] = field_errors(launch(kname), want[kname], FIELD_TOL)
        print(f"  {kname} max|kernel-plain|: "
              + show(errs[kname], FIELD_TOL), flush=True)
        bad += [f"{kname}: {x} over its bound"
                for x in over(errs[kname], FIELD_TOL)]
    for fault, over_kw in PLANTED_FAULTS.items():
        for kname in ("predictor", "corrector"):
            per = field_errors(launch(kname, **over_kw), want[kname],
                               FIELD_TOL)
            print(f"  planted fault {kname} {fault}, one substep: "
                  + show(per, FIELD_TOL), flush=True)
            if not over(per, FIELD_TOL):
                bad.append(f"{kname} with {fault} stays within every bound")

    # the diffusion of each field, one substep from the rough state: on the
    # smooth state one substep of it moves u, v and pott less than fp32
    # rounding, and more steps grow the rounding as fast as the missing
    # diffusion, so only qv showed a kernel without diffusion
    rough = ci.rough
    rp = fs.fused_substep_plain(rough, None, g, f, dt, **kw)
    rough_want = {"predictor": rp,
                  "corrector": fs.fused_substep_plain(rp, rough, g, f, dt,
                                                      **kw)}
    for kname in ("predictor", "corrector"):
        base = None if kname == "predictor" else rough
        ev = rough if kname == "predictor" else rp
        for fault, over_kw in (("sound", {}),
                               ("with_diff=False", {"with_diff": False})):
            k = dict(kw, **over_kw)
            got = (fs.predictor(ev, g, f, dt, **k) if base is None
                   else fs.corrector(ev, base, g, f, dt, **k))
            per = field_errors(got, rough_want[kname], FIELD_TOL)
            print(f"  rough state, {kname} {fault}, one substep: "
                  + show(per, FIELD_TOL), flush=True)
            if fault == "sound":
                bad += [f"{kname} on the rough state: {x} over its bound"
                        for x in over(per, FIELD_TOL)]
            else:
                bad += [f"{kname} without diffusion keeps {x} within its "
                        "bound on the rough state" for x in DIFFUSED
                        if x not in over(per, FIELD_TOL)]

    # -- the wall as a mask (the packed scan) --
    vm = ci.vmask
    pm = fs.predictor(st, g, f, dt, vmask=vm, **kw)
    if not bitwise_equal(pm, launch("predictor")):
        bad.append("masked predictor differs from the index rule")
    errs["predictor_masked"] = field_errors(
        pm, fs.fused_substep_plain(st, None, g, f, dt, vmask=vm, **kw),
        FIELD_TOL)
    print("  predictor (mask) max|kernel-plain|: "
          + show(errs["predictor_masked"], FIELD_TOL), flush=True)
    bad += [f"masked predictor: {x} over its bound"
            for x in over(errs["predictor_masked"], FIELD_TOL)]
    row = g.ny // 2
    holed = vm.clone()
    holed[row] = 0.0
    ph = fs.predictor(st, g, f, dt, vmask=holed, **kw)
    per = field_errors(ph, fs.fused_substep_plain(st, None, g, f, dt,
                                                  vmask=holed, **kw),
                       FIELD_TOL)
    if bool(ph.v[:, row].abs().max() != 0) or over(per, FIELD_TOL):
        bad.append(f"predictor with v row {row} masked: v there "
                   f"{float(ph.v[:, row].abs().max())}, {per}")

    # -- the corrector with the physics epilogue, on the moist state --
    kern, plain = epilogue_pair(ci)
    want_epi = plain()
    got = kern()
    errs["corrector_epilogue"] = field_errors(got, want_epi, EPI_TOL)
    no_mic = epilogue_pair(ci, phys=phys_with(ci.cfg,
                                              microphysics=False))[1]()
    n_cond = int((want_epi.qv < no_mic.qv).sum())
    rain_inc = float((want_epi.rain - ci.moist.rain).max())
    print(f"  moist state: {n_cond} of {want_epi.qv.numel()} cells condense "
          f"in the plain epilogue; largest rain increment {rain_inc:.3e} "
          "kg/m2", flush=True)
    if n_cond == 0 or not rain_inc > 0:
        bad.append("the moist state does not condense or rain")
    print("  corrector+epilogue (mask) max|kernel-plain|: "
          + show(errs["corrector_epilogue"], EPI_TOL), flush=True)
    bad += [f"epilogue corrector: {x} over its bound"
            for x in over(errs["corrector_epilogue"], EPI_TOL)]
    unmasked = fs.corrector(*epilogue_args(ci), phys=ci.phys, **kw)
    if not bitwise_equal(got, unmasked, tuple(EPI_TOL)):
        bad.append("masked epilogue corrector differs from the index rule")
    kern_h, plain_h = epilogue_pair(ci, vmask=holed)
    got_h, want_h = kern_h(), plain_h()
    per = field_errors(got_h, want_h, EPI_TOL)
    if bool(got_h.v[:, row].abs().max() != 0) or over(per, EPI_TOL):
        bad.append(f"epilogue corrector with v row {row} masked: {per}")
    print(f"  v row {row} masked: predictor and epilogue corrector zero it "
          "and match their plain versions; the single-device mask equals "
          "the index rule bit for bit", flush=True)
    kern_c, plain_c = epilogue_pair(ci, phys=phys_with(ci.cfg,
                                                       convection=True))
    errs["corrector_epilogue_convection"] = field_errors(kern_c(), plain_c(),
                                                         EPI_TOL)
    print("  corrector+epilogue, convection on: "
          + show(errs["corrector_epilogue_convection"], EPI_TOL), flush=True)
    bad += [f"epilogue corrector with convection: {x} over its bound"
            for x in over(errs["corrector_epilogue_convection"], EPI_TOL)]
    for term in EPI_FAULTS:
        kf = epilogue_pair(ci, phys=phys_with(ci.cfg, **{term: False}))[0]
        per = field_errors(kf(), want_epi, EPI_TOL)
        print(f"  planted fault epilogue without {term}, one call (one "
              "shows each term above rounding): " + show(per, EPI_TOL),
              flush=True)
        if not over(per, EPI_TOL):
            bad.append(f"epilogue without {term} stays within every bound")
    if bad:
        raise AssertionError("; ".join(bad))
    return errs


def time_kernels(ci: CheckInputs, card: str) -> dict:
    """Phase 4: each variant and its plain version, in turns (kernel,
    plain, plain, kernel), beside its bound."""
    g, f, dt, st, kw, vm = (ci.grid, ci.forcing, ci.grid.dt, ci.state,
                            ci.kw, ci.vmask)
    pred_plain = fs.fused_substep_plain(st, None, g, f, dt, **kw)
    ev, base = epilogue_args(ci)[:2]
    calls = {
        "predictor": (
            lambda: fs.predictor(st, g, f, dt, **kw),
            lambda: fs.fused_substep_plain(st, None, g, f, dt, **kw),
            (st, None, None, None)),
        "corrector": (
            lambda: fs.corrector(pred_plain, st, g, f, dt, **kw),
            lambda: fs.fused_substep_plain(pred_plain, st, g, f, dt, **kw),
            (pred_plain, st, None, None)),
        "predictor_masked": (
            lambda: fs.predictor(st, g, f, dt, vmask=vm, **kw),
            lambda: fs.fused_substep_plain(st, None, g, f, dt, vmask=vm,
                                           **kw),
            (st, None, None, vm)),
        "corrector_epilogue": (
            *epilogue_pair(ci), (ev, base, ci.phys, vm)),
    }
    timing = {}
    for kname, (kern, plain, (e, b, phys, vmask)) in calls.items():
        timing[kname] = kernel_timing(kname, kern, plain, substep_bound_ms(
            e, b, g, f, kern(), phys=phys, vmask=vmask), card)
    return timing


def kernel_timing(name, kern, plain, bound, card) -> dict:
    """A kernel and its plain version timed in turns (kernel, plain, plain,
    kernel): device ms per call (``device_ms``) and the host's enqueue ms
    beside it, against ``bound`` = (bound ms, what bounds it)."""
    (k1, kh1), (p1, ph1), (p2, ph2), (k2, kh2) = (
        device_ms(kern), device_ms(plain), device_ms(plain), device_ms(kern))
    (bound_ms, by), ms = bound, 0.5 * (k1 + k2)
    split = launch_ms(kern)
    tm = dict(ms=ms, plain_ms=0.5 * (p1 + p2), bound_ms=bound_ms,
              bound_by=by, enqueue_ms=0.5 * (kh1 + kh2),
              plain_enqueue_ms=0.5 * (ph1 + ph2), launch_ms=split)
    per_launch = ("not measured (the profiler saw no device time)"
                  if split is None else ", ".join(
                      f"{k} {v:.4f}" for k, v in split.items()))
    print(f"  {name}: kernel {ms:.4f} ms on the device ({k1:.4f}, "
          f"{k2:.4f}; per launch, profiled: {per_launch}), "
          f"{tm['enqueue_ms']:.4f} ms host enqueue; plain "
          f"{tm['plain_ms']:.4f} ms ({p1:.4f}, {p2:.4f}), "
          f"{tm['plain_enqueue_ms']:.4f} ms enqueue; bound {bound_ms:.5f} ms "
          f"({by}; {100 * bound_ms / ms:.1f}% of it); no PyTorch library "
          f"call computes it (library_ms null) [{card}]", flush=True)
    return tm


def sanity(s, grid, s0):
    """The run's sanity checks against its initial state ``s0``; raises on
    the first that fails."""
    for f in STATE_FIELDS:
        if not bool(torch.isfinite(getattr(s, f)).all()):
            raise AssertionError(f"non-finite {f} after the run")
    max_wind = max(float(s.u.abs().max()), float(s.v.abs().max()))
    area = grid.area.double()[:, None]
    w = area / area.sum() / s.colp.shape[-1]
    mean_colp = float((s.colp.double() * w).sum())
    pott_lo, pott_hi = float(s.pott.min()), float(s.pott.max())
    mass0 = float((s0.colp.double() * area).sum())
    mass1 = float((s.colp.double() * area).sum())
    drift = abs(mass1 - mass0) / mass0
    checks = [(max_wind < MAX_WIND, f"max wind {max_wind:.2f} < {MAX_WIND}"),
              (MEAN_COLP[0] < mean_colp < MEAN_COLP[1],
               f"mean COLP {mean_colp:.1f} in {MEAN_COLP}"),
              (POTT_RANGE[0] <= pott_lo and pott_hi <= POTT_RANGE[1],
               f"POTT [{pott_lo:.2f}, {pott_hi:.2f}] in {POTT_RANGE}"),
              (drift < MASS_DRIFT, f"mass drift {drift:.3e} < {MASS_DRIFT}")]
    for ok, what in checks:
        print(f"  {'ok ' if ok else 'BAD'} {what}", flush=True)
        if not ok:
            raise AssertionError(what)


def main_path(dev, card: str):
    """Phase 5: the run command through the packed scan, counted."""
    args = cli.make_parser().parse_args(MAIN_ARGV)
    run_cfg = cli.build_config(args)
    s0, _, g0 = initialize(run_cfg, device=dev)
    reset_counts()
    res = cli.run(run_cfg, device=args.device)
    counts = read_counts()
    s = res.state
    if res.aborted:
        raise AssertionError("the run aborted on a non-finite state")
    every = run_cfg.physics.rad_every_steps
    want = dict.fromkeys(counts, 0)
    want.update(predictor_masked=res.steps, corrector_epilogue=res.steps,
                radiation_refreshes=sum(1 for k in range(res.steps)
                                        if k % every == 0))
    if counts != want:
        raise AssertionError(f"counts {counts} for {res.steps} steps, "
                             f"expected {want}: one masked predictor and "
                             "one epilogue corrector a step, radiation every "
                             f"{every} steps, nothing else")
    if len(res.chunks) < 3:
        raise AssertionError(f"chunks {res.chunks}: expected three")
    dt0 = res.dts[0]
    if dt0 != g0.dt:
        raise AssertionError(f"first dt {dt0} != the grid's {g0.dt}")
    for rec, dt_next in zip(res.records[:-1], res.dts[1:]):
        want_dt = round_to(max(adaptive_cfl_dt(res.min_dx,
                                               run_cfg.numerics.cfl,
                                               rec["max_wind"]), 0.05 * dt0),
                           torch.float32)
        if dt_next != want_dt:
            raise AssertionError(f"dt {dt_next} != adaptive_cfl_dt {want_dt}")
    horizon = run_cfg.sim_days * 86400.0
    if abs(float(s.t) - horizon) > 0.5 * res.dts[-1]:
        raise AssertionError(f"t = {float(s.t)} s misses the horizon "
                             f"{horizon} s")
    sanity(s, res.grid, s0)
    points = run_cfg.grid.nx * run_cfg.grid.ny * run_cfg.grid.nz
    steady_steps = sum(res.chunks[1:])
    steady_wall = sum(r["wall_s"] for r in res.records[1:])
    steady_ms = 1e3 * steady_wall / steady_steps
    print(f"  {res.steps} steps {res.chunks} in {res.wall_s:.3f}s: "
          f"{1e3 * res.wall_s / res.steps:.3f} ms/step "
          f"({points * res.steps / res.wall_s / 1e6:.2f} M grid-points/s); "
          f"after the first chunk {steady_ms:.3f} ms/step "
          f"({points * steady_steps / steady_wall / 1e6:.2f} "
          f"M grid-points/s); dt {res.dts}; counts {counts} [{card}]",
          flush=True)
    return run_cfg, res, counts, steady_ms


def per_step_path(run_cfg, n, dev, card: str):
    """Phase 6: the per-step path for ``n`` steps from the initial state,
    counted and checked; the packed scan over the same steps compared with
    it; both timed in turns."""
    s0, forcing, grid = initialize(run_cfg, device=dev)
    step = make_step_fn(run_cfg)
    packed = make_chunk_runner(run_cfg, n)

    def per_step():
        return run_scan(step, s0, grid, forcing, n)

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t) / n

    reset_counts()
    a, ms_a1 = wall(per_step)
    counts = read_counts()
    every = run_cfg.physics.rad_every_steps
    want = dict.fromkeys(counts, 0)
    want.update(predictor=n, corrector=n, surface_split=n,
                turbulence_split=n, microphysics_split=n,
                radiation_refreshes=sum(1 for k in range(n)
                                        if k % every == 0))
    if counts != want:
        raise AssertionError(f"per-step path counts {counts} for {n} steps, "
                             f"expected {want}")
    sanity(a, grid, s0)
    b, ms_b1 = wall(lambda: packed(s0, grid, forcing))
    b2, ms_b2 = wall(lambda: packed(s0, grid, forcing))
    _, ms_a2 = wall(per_step)
    if not bitwise_equal(b, b2, STATE_FIELDS):
        raise AssertionError("two packed-scan runs from one state differ")
    per = field_errors(b, a, PATHS_TOL)
    print(f"  {n} steps, packed scan vs per-step path: "
          + show(per, PATHS_TOL), flush=True)
    if over(per, PATHS_TOL):
        raise AssertionError(f"the two paths differ beyond their bounds: "
                             f"{per}")
    ms_a, ms_b = 0.5 * (ms_a1 + ms_a2), 0.5 * (ms_b1 + ms_b2)
    print(f"  ms/step over {n} steps from the initial state (radiation "
          f"refresh included): per-step path {ms_a:.3f} ({ms_a1:.3f}, "
          f"{ms_a2:.3f}), packed scan {ms_b:.3f} ({ms_b1:.3f}, {ms_b2:.3f}); "
          f"per-step counts {counts} [{card}]", flush=True)
    return counts, per, ms_a, ms_b


def breakdown(cfg, state, grid, forcing, step_ms, card):
    """Each layer of a model step timed alone on the final state of the main
    path: ms per call over back-to-back calls (CUDA events; the device's time
    where it exceeds the host's) and the host's enqueue ms per call. Their
    sums for each path, weighted by calls per step, are set beside the
    measured ms/step of the main path."""
    from climate_model_tpu_torch.io.metrics import diagnostics
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    dt = grid.dt
    vm = fs.wall_mask(grid.ny, torch.float32, state.device)
    phys = phys_epilogue_tuple(cfg)
    pred = fs.predictor(state, grid, forcing, dt, **kw)
    press = diagnose_pressure(state.colp, grid)
    every = cfg.physics.rad_every_steps
    # (name, fn, calls a step on the packed scan, on the per-step path)
    layers = [
        (f"radiation refresh (1 step in {every})",
         lambda: radiation.compute_radiation(state, grid, forcing, cfg),
         1.0 / every, 1.0 / every),
        ("predictor kernel (mask)", lambda: fs.predictor(
            state, grid, forcing, dt, vmask=vm, **kw), 1.0, 0.0),
        ("corrector kernel with physics epilogue (mask)",
         lambda: fs.corrector(pred, state, grid, forcing, dt, phys=phys,
                              vmask=vm, **kw), 1.0, 0.0),
        ("predictor kernel", lambda: fs.predictor(state, grid, forcing, dt,
                                                  **kw), 0.0, 1.0),
        ("corrector kernel", lambda: fs.corrector(pred, state, grid, forcing,
                                                  dt, **kw), 0.0, 1.0),
        ("pressure diagnostics", lambda: diagnose_pressure(state.colp, grid),
         0.0, 1.0),
        ("surface split", lambda: surface.surface_step(
            state, grid, forcing, cfg, dt, press=press), 0.0, 1.0),
        ("turbulence split", lambda: turbulence.turbulence_step(
            state, grid, forcing, cfg, dt, press=press), 0.0, 1.0),
        ("microphysics split", lambda: microphysics.microphysics_step(
            state, grid, forcing, cfg, dt, press=press), 0.0, 1.0),
        ("chunk diagnostics (1 per chunk)",
         lambda: diagnostics(state, grid, forcing, cfg), 1.0 / 105,
         1.0 / 105),
    ]
    sums, host_sums = [0.0, 0.0], [0.0, 0.0]
    for name, fn, packed_share, step_share in layers:
        dev_ms = timed(fn, n=20, warmup=3)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = 1e3 * (time.perf_counter() - h0) / 20
        torch.cuda.synchronize()
        sums[0] += packed_share * dev_ms
        sums[1] += step_share * dev_ms
        host_sums[0] += packed_share * host_ms
        host_sums[1] += step_share * host_ms
        print(f"  {name}: back-to-back {dev_ms:.4f} ms, host enqueue "
              f"{host_ms:.4f} ms per call", flush=True)
    print(f"  layers summed per step: packed scan {sums[0]:.3f} ms (against "
          f"{step_ms:.3f} ms/step of the main path), per-step path "
          f"{sums[1]:.3f} ms [{card}]", flush=True)
    print(f"  one packed-scan step, host against device: {host_sums[0]:.3f} "
          f"ms of host enqueue, {sums[0]:.3f} ms of device time (layers "
          f"summed as above; the larger bounds the step) [{card}]",
          flush=True)


def windy_state(state):
    """``state`` with strong winds near the surface and vertical shear: u
    raised by up to 40 m/s and v lowered by up to 30 m/s over the lowest
    four levels (full at the bottom, v's wall row kept at 0). On the moist
    check state the bottom winds are a few m/s, and neither the surface
    drag nor the K-diffusion of u and v moves them by more than fp32
    rounding in one call; here each moves them by far more."""
    nz = state.u.shape[0]
    k = torch.arange(nz, dtype=state.dtype, device=state.device)
    ramp = ((k - (nz - 5)) / 4.0).clamp(0.0, 1.0)[:, None, None]
    v = state.v - 30.0 * ramp
    v[:, 0] = 0.0
    return state.replace(u=state.u + 40.0 * ramp, v=v)


def check_momentum(ci: CheckInputs, bad: list):
    """The epilogue corrector on the windy state: sound within EPI_TOL,
    and without the surface or the turbulence u and v each over it."""
    g, f, dt = ci.grid, ci.forcing, ci.grid.dt
    windy = windy_state(ci.moist)
    pred = fs.fused_substep_plain(windy, None, g, f, dt, vmask=ci.vmask,
                                  **ci.kw)

    def call(kernel, phys):
        fn = fs.corrector if kernel else fs.fused_substep_plain
        return fn(pred, windy, g, f, dt, phys=phys, vmask=ci.vmask, **ci.kw)

    want = call(False, ci.phys)
    per = field_errors(call(True, ci.phys), want, EPI_TOL)
    print("  windy state, corrector+epilogue max|kernel-plain|: "
          + show(per, EPI_TOL), flush=True)
    bad += [f"epilogue corrector on the windy state: {x} over its bound"
            for x in over(per, EPI_TOL)]
    for term in MOMENTUM_FAULTS:
        per = field_errors(call(True, phys_with(ci.cfg, **{term: False})),
                           want, EPI_TOL)
        print(f"  planted fault epilogue without {term}, windy state: u "
              f"{per['u']:.3e}, v {per['v']:.3e} (bounds "
              f"{EPI_TOL['u']:.1e}, {EPI_TOL['v']:.1e})", flush=True)
        bad += [f"epilogue without {term} keeps {x} within its bound on "
                "the windy state" for x in ("u", "v")
                if x not in over(per, EPI_TOL)]


def check_tall(dev, bad: list):
    """The epilogue corrector on a column of TALL_NZ levels (three levels a
    lane of its warp) against its plain version, on the moist state."""
    b3 = baseline_config(3)
    cfg = resolve_rad_interval(b3.replace(grid=dataclasses.replace(
        b3.grid, nx=TALL_GRID[0], ny=TALL_GRID[1], nz=TALL_NZ)))
    state, forcing, grid = initialize(cfg, device=dev)
    moist = moist_state(state, grid, cfg)
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    vm = fs.wall_mask(grid.ny, torch.float32, dev)
    pred = fs.fused_substep_plain(moist, None, grid, forcing, grid.dt,
                                  vmask=vm, **kw)
    args = (pred, moist, grid, forcing, grid.dt)
    phys = phys_epilogue_tuple(cfg)
    per = field_errors(fs.corrector(*args, phys=phys, vmask=vm, **kw),
                       fs.fused_substep_plain(*args, phys=phys, vmask=vm,
                                              **kw), TALL_TOL)
    print(f"  {TALL_NZ} levels on {TALL_GRID[0]}x{TALL_GRID[1]}, "
          "corrector+epilogue max|kernel-plain|: "
          + show(per, TALL_TOL), flush=True)
    bad += [f"{TALL_NZ}-level epilogue: {x} over its bound"
            for x in over(per, TALL_TOL)]


@dataclasses.dataclass
class Block:
    """A shard's block cut from the #4 check state, with its statics."""

    name: str
    lay: object
    state: object
    grid: object
    forcing: object
    vmask: torch.Tensor
    strips: list


def noisy4(dev):
    """Config #4 at full width, 10 plain steps from the initial state, its
    moisture raised near saturation, grid-scale noise added, and colp
    +-20 Pa. Returns (cfg, state, forcing, grid)."""
    cfg = baseline_config(4)
    state, forcing, grid = initialize(cfg, device=dev)
    plain_step = make_step_fn(cfg, dynamics=functools.partial(step_matsuno,
                                                              cfg=cfg))
    for _ in range(10):
        state = plain_step(state, grid, forcing)
    state = rough_state(moist_state(state, grid, cfg))
    r = np.random.default_rng(SEED + 2)
    colp = state.colp + torch.as_tensor(r.normal(0.0, 20.0,
                                                 state.colp.shape),
                                        dtype=state.dtype, device=dev)
    return cfg, state.replace(colp=colp), forcing, grid


def shard_blocks(cfg, state, forcing, grid, dev):
    """The blocks of CHECK_BLOCKS cut from ``state``. Returns (blocks, kw,
    phys)."""
    blocks = []
    for name, (n_lat, n_lon), shard in CHECK_BLOCKS:
        lay = sharding.layout(Mesh(n_lat, n_lon, dev), shard, grid.ny,
                              grid.nx)
        g = sharding.split_grid(grid, lay)
        f = sharding.split_forcing(forcing, lay)
        vm = row_mask(lay, torch.float32, dev)
        strips = [SeamStrip(side, lay, g, f, vm, sharding.Halo())
                  for side, has in (("south", lay.gs), ("north", lay.gn))
                  if has]
        blocks.append(Block(name, lay, sharding.split_state(state, lay), g,
                            f, vm, strips))
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    return blocks, kw, phys_epilogue_tuple(cfg)


def kept_rows(b: Block, st) -> slice:
    """The rows of strip ``st`` that replace the main launch's and lie in
    the block's interior, in strip coordinates."""
    d0, _, n = st.keep
    lo, hi = max(d0, b.lay.rows.start), min(d0 + n, b.lay.rows.stop)
    return slice(lo - st.r0, hi - st.r0)


def region_errors(got, want, rows, cols, tol) -> dict:
    """field_errors over rows x cols of each field."""
    per = {}
    for f in tol:
        a = getattr(got, f)[..., rows, cols]
        b = getattr(want, f)[..., rows, cols]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {f} from the kernel")
        per[f] = float((a - b).abs().max())
    return per


def shard_calls(b: Block, kw, phys, dt):
    """(variant, kernel call, plain call, rows, tol, (ev, base, phys,
    vmask, grid, forcing)) of every shard-local and seam-strip program on
    block ``b``."""
    skw = dict(kw, vmask=b.vmask)
    s, g, f = b.state, b.grid, b.forcing
    pred = fs.fused_substep_plain(s, None, g, f, dt, **skw)
    calls = [
        ("predictor_shard",
         lambda: fs.predictor(s, g, f, dt, part="shard", **skw),
         lambda: fs.fused_substep_plain(s, None, g, f, dt, **skw),
         b.lay.rows, SHARD_TOL, (s, None, None, b.vmask, g, f)),
        ("corrector_shard",
         lambda: fs.corrector(pred, s, g, f, dt, phys=phys, part="shard",
                              **skw),
         lambda: fs.fused_substep_plain(pred, s, g, f, dt, phys=phys, **skw),
         b.lay.rows, SHARD_EPI_TOL, (pred, s, phys, b.vmask, g, f))]
    for st in b.strips:
        ss, ps = st.cut(s), st.cut(pred)
        tkw = dict(skw, vmask=st.vmask)
        sg, sf = st.grid, st.forcing
        calls += [
            (f"predictor_{st.part}",
             functools.partial(fs.predictor, ss, sg, sf, dt, part=st.part,
                               **tkw),
             functools.partial(fs.fused_substep_plain, ss, None, sg, sf, dt,
                               **tkw),
             kept_rows(b, st), SHARD_TOL, (ss, None, None, st.vmask, sg, sf)),
            (f"corrector_{st.part}",
             functools.partial(fs.corrector, ps, ss, sg, sf, dt, phys=phys,
                               part=st.part, **tkw),
             functools.partial(fs.fused_substep_plain, ps, ss, sg, sf, dt,
                               phys=phys, **tkw),
             kept_rows(b, st), SHARD_EPI_TOL, (ps, ss, phys, st.vmask, sg, sf))]
    return calls


def check_shards(noisy, dev, bad: list):
    """Each shard-local and seam-strip variant against its plain version on
    the blocks of CHECK_BLOCKS cut from the ``noisy4`` state. Returns
    (errors by variant, the blocks and what the timing needs)."""
    blocks, kw, phys = shard_blocks(*noisy, dev)
    dt = blocks[0].grid.dt
    errs = {}
    for b in blocks:
        lay = b.lay
        print(f"  {b.name} block: shard ({lay.lat_idx}, {lay.lon_idx}), "
              f"{tuple(b.state.u.shape)} with ghosts s/n/cols "
              f"{lay.gs}/{lay.gn}/{lay.gx}", flush=True)
        for name, kern, plain, rows, tol, _ in shard_calls(b, kw, phys, dt):
            per = region_errors(kern(), plain(), rows, lay.cols, tol)
            errs[name] = {f: max(e, errs.get(name, {}).get(f, 0.0))
                          for f, e in per.items()}
            print(f"    {name} max|kernel-plain| (interior): "
                  + show(per, tol), flush=True)
            bad += [f"{name} on the {b.name} block: {x} over its bound"
                    for x in over(per, tol)]
    return errs, (blocks, kw, phys, dt)


def time_shards(shard_inputs, card: str) -> dict:
    """Each shard-local and seam-strip variant and its plain version, in
    turns, at #4's 2x4 shapes (the lon-seam block and its south strip, the
    polar-edge block's north strip), beside its bound."""
    blocks, kw, phys, dt = shard_inputs
    by_name = {b.name: b for b in blocks}
    timing = {}
    for bname, names in (("lon-seam", ("predictor_shard", "corrector_shard",
                                       "predictor_south_strip",
                                       "corrector_south_strip")),
                         ("polar-edge", ("predictor_north_strip",
                                         "corrector_north_strip"))):
        b = by_name[bname]
        for name, kern, plain, _, _, (ev, base, ph, vm, g, f) in shard_calls(
                b, kw, phys, dt):
            if name not in names:
                continue
            timing[name] = kernel_timing(
                f"{name} at {tuple(ev.u.shape)}", kern, plain,
                substep_bound_ms(ev, base, g, f, kern(), phys=ph, vmask=vm),
                card)
    return timing


def run_argv(argv, dev):
    """``cli.run`` of ``argv``, with every counter set to 0 just before and
    read just after. Returns (cfg, result, counts, steady ms/step)."""
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    reset_counts()
    res = cli.run(cfg, device=dev)
    counts = read_counts()
    if res.aborted:
        raise AssertionError(f"{argv}: the run aborted on a non-finite state")
    steady = 1e3 * sum(r["wall_s"] for r in res.records[1:]) \
        / max(sum(res.chunks[1:]), 1)
    return cfg, res, counts, steady


def state_diffs(a, b) -> dict:
    """max|a - b| of every state field; inf where a is not finite."""
    return {f: (float((getattr(a, f) - getattr(b, f)).abs().max())
                if bool(torch.isfinite(getattr(a, f)).all())
                else float("inf")) for f in STATE_FIELDS}


class _LeaveOut:
    """An exchange with part of its work left out (a planted fault)."""

    def __init__(self, inner, what: str):
        self.inner, self.what, self.calls = inner, what, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def refresh_cols(self, fields):
        # the schedule refreshes the columns twice a step: the time-n
        # fields, then the predicted ones
        self.calls += 1
        if self.what == "lon exchange" or (
                self.what == "lon exchange after the predictor"
                and self.calls % 2 == 0):
            return
        self.inner.refresh_cols(fields)

    def start_lat(self, fields):
        if self.what == "lat exchange":
            return _NoWait()
        return self.inner.start_lat(fields)


class _NoWait:
    def wait(self):
        pass


def sharded_steps(cfg, noisy, n, dev, halo=sharding.Halo(),
                  leave_out=None):
    """``n`` steps of the sharded runner of ``cfg`` from the ``noisy4``
    state, optionally with a planted fault; the gathered final state."""
    _, s0, f0, g0 = noisy
    ss = sharding.shard(make_mesh(cfg, device=dev), s0, g0, f0, halo)
    if leave_out:
        ss = ss.replace(exchange=_LeaveOut(ss.exchange, leave_out))
    return sharding.gather(make_chunk_runner(cfg, n)(ss, g0, f0))


def sharded_path(noisy, dev, card: str):
    """Phase 8: BASELINE #4 on its 2x4 mesh in one process through the run
    command, with halo overlap (counted), then the blocking schedule and
    the unsharded grid from the same initial state; each pair compared.
    Then FAULT_STEPS steps from the ``noisy4`` state: the sound sharded run
    and each planted fault against the unsharded grid."""
    bad = []
    runs = {}
    for name, argv in (("overlap", SHARDED_ARGV), ("blocking", BLOCKING_ARGV),
                       ("unsharded", UNSHARDED_ARGV)):
        runs[name] = run_argv(argv, dev)
        cfg, res, counts, steady = runs[name]
        every = cfg.physics.rad_every_steps
        refreshes = sum(1 for k in range(res.steps) if k % every == 0)
        want = dict.fromkeys(counts, 0)
        n = res.steps
        if name == "unsharded":
            want.update(predictor_masked=n, corrector_epilogue=n,
                        radiation_refreshes=refreshes)
        else:
            shards = cfg.sharding.mesh_lat * cfg.sharding.mesh_lon
            want.update(predictor_shard=shards * n,
                        corrector_shard=shards * n,
                        radiation_refreshes=shards * refreshes)
            if name == "overlap":
                seams = cfg.sharding.mesh_lon * (cfg.sharding.mesh_lat - 1)
                for part in ("south_strip", "north_strip"):
                    want[f"predictor_{part}"] = seams * n
                    want[f"corrector_{part}"] = seams * n
        print(f"  {name}: {res.path}; {n} steps {res.chunks}, "
              f"{1e3 * res.wall_s / n:.3f} ms/step, after the first chunk "
              f"{steady:.3f} ms/step; counts {counts} [{card}]", flush=True)
        if counts != want:
            bad.append(f"{name}: counts {counts}, expected {want}")
    s0, _, g0 = initialize(runs["overlap"][0], device=dev)
    sanity(runs["overlap"][1].state, runs["overlap"][1].grid, s0)
    base = runs["unsharded"][1]
    for name in ("overlap", "blocking"):
        if runs[name][1].dts != base.dts:
            bad.append(f"{name}: dts {runs[name][1].dts} != {base.dts}")
    pairs = (("overlap", "unsharded"), ("blocking", "unsharded"),
             ("overlap", "blocking"))
    for a, b in pairs:
        sa, sb = runs[a][1].state, runs[b][1].state
        per = state_diffs(sa, sb)
        same = bitwise_equal(sa, sb, STATE_FIELDS)
        print(f"  {a} vs {b}: bitwise equal {same}; "
              + show({f: per[f] for f in SHARDED_TOL}, SHARDED_TOL),
              flush=True)
        bad += [f"{a} vs {b}: {x} over its bound"
                for x in over({f: per[f] for f in SHARDED_TOL}, SHARDED_TOL)]
    cfg, cfg1 = runs["overlap"][0], runs["unsharded"][0]
    _, s0, f0, g0 = noisy
    want = make_chunk_runner(cfg1, FAULT_STEPS)(s0, g0, f0)
    for fault, kw in (("none (sound)", {}),
                      ("lon exchange left out", dict(leave_out="lon exchange")),
                      ("lon exchange left out after the predictor only",
                       dict(leave_out="lon exchange after the predictor")),
                      ("strips on stale lat rows (lat exchange left out)",
                       dict(leave_out="lat exchange")),
                      ("ghosts one row and column narrower (2)",
                       dict(halo=sharding.Halo(2, 2, 2)))):
        got = sharded_steps(cfg, noisy, FAULT_STEPS, dev, **kw)
        per = state_diffs(got, want)
        per = {f: per[f] for f in SHARDED_TOL}
        same = bitwise_equal(got, want, STATE_FIELDS)
        print(f"  noisy #4 state, {FAULT_STEPS} steps, overlap run, planted "
              f"fault: {fault}; vs unsharded, bitwise equal {same}: "
              + show(per, SHARDED_TOL), flush=True)
        if fault == "none (sound)":
            bad += [f"sound sharded run from the noisy state: {x} over its "
                    "bound" for x in over(per, SHARDED_TOL)]
        elif "after the predictor only" in fault:
            pass        # a reading, not a gate (PERF.md, Findings)
        elif not over(per, SHARDED_TOL):
            bad.append(f"the {fault} stays within every bound")
    if bad:
        raise AssertionError("; ".join(bad))
    return {name: r[2] for name, r in runs.items()}


def backend_path(dev, card: str):
    """Phase 9: BASELINE #1 (backend='jnp') on the card: the plain per-step
    path, no kernel launch, finite fields."""
    cfg, res, counts, _ = run_argv(BACKEND_ARGV, dev)
    launched = {k: v for k, v in counts.items() if v}
    if not res.path.startswith("per-step (plain") or launched:
        raise AssertionError(f"baseline 1 took {res.path!r}, counts "
                             f"{launched}")
    for f in STATE_FIELDS:
        if not bool(torch.isfinite(getattr(res.state, f)).all()):
            raise AssertionError(f"non-finite {f} after baseline 1")
    print(f"  {cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz} backend="
          f"{cfg.backend}: {res.path}; {res.steps} steps, no kernel launch "
          f"(every counter 0), finite fields, max|V| "
          f"{res.records[-1]['max_wind']:.2f} m/s [{card}]", flush=True)


def same_state(a, b) -> bool:
    """Every field of two States equal bit for bit: the prognostic fields,
    the radiation caches, ``t`` and ``step``."""
    return (a.step == b.step and torch.equal(a.t, b.t)
            and bitwise_equal(a, b, STATE_FIELDS))


def nc_vars(path) -> dict:
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:]) for k, v in f.variables.items()}


def metric_steps(out_dir) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


def host_ms(fn, reps=IO_TIMING_REPS) -> float:
    """Host wall ms per call of ``fn``, the card synchronised around."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / reps


def io_path(dev, card: str, main_steady_ms: float):
    """Phase 10: config #3 through ``cli.run`` with an out-dir, continuous
    and split across a checkpoint, bit for bit; planted resume faults; #4
    on its 2x4 mesh split across a checkpoint saved from the gathered
    state; the io layer's times."""
    try:
        import matplotlib
        probe = f"matplotlib {matplotlib.__version__} importable"
    except ImportError as e:
        probe = f"matplotlib not importable ({e})"
    print(f"  probe (gates nothing): {probe}", flush=True)
    bad = []
    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        _io3(dev, card, main_steady_ms, root, bad)
        _io4(dev, card, root, bad)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if bad:
        raise AssertionError("; ".join(bad))


def _io3(dev, card, main_steady_ms, root, bad):
    cfg = cli.build_config(cli.make_parser().parse_args(MAIN_ARGV))
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    # 1. continuous, with every file
    reset_counts()
    ra = cli.run(cfg, device=dev, out_dir=a)
    counts = read_counts()
    if counts["predictor_masked"] != ra.steps \
            or counts["corrector_epilogue"] != ra.steps:
        bad.append(f"#3 with output: counts {counts} for {ra.steps} steps")
    n = len(ra.chunks)
    want = sorted(["constants.nc", "metrics.jsonl", "restart.npz"]
                  + [f"out_{i:04d}.nc" for i in range(n)])
    if n != 3 or sorted(os.listdir(a)) != want:
        bad.append(f"#3 with output: chunks {ra.chunks}, files "
                   f"{sorted(os.listdir(a))}, expected {want}")
    steps_a = metric_steps(a)
    if len(steps_a) != n or steps_a != sorted(set(steps_a)) \
            or steps_a[-1] != ra.steps:
        bad.append(f"#3 metrics.jsonl steps {steps_a}")
    ck = load_checkpoint(os.path.join(a, "restart.npz"), cfg, device=dev)
    last = nc_vars(os.path.join(a, f"out_{n - 1:04d}.nc"))
    s = ra.state
    nc_ok = all(np.array_equal(last[k][0], getattr(s, f).cpu().numpy())
                for k, f in NC_FIELDS.items())
    nc_ok &= bool(last["time"][0] == np.float32(float(s.t) / 86400.0))
    for k in ("TAIR", "PHI", "WWIND"):
        nz = s.u.shape[0] + (k == "WWIND")
        nc_ok &= last[k].shape == (1, nz) + tuple(s.u.shape[1:]) \
            and bool(np.isfinite(last[k]).all())
    steady = 1e3 * sum(r["wall_s"] for r in ra.records[1:]) \
        / sum(ra.chunks[1:])
    print(f"  #3 with --out-dir: {ra.steps} steps {ra.chunks}, files "
          f"{sorted(os.listdir(a))}; metrics steps {steps_a}; checkpoint "
          f"read back equal to the final state bit for bit: "
          f"{same_state(ck, s)}; last NetCDF file equal to it (prognostic "
          f"fields bit for bit, TAIR/PHI/WWIND finite): {nc_ok}; after the "
          f"first chunk {steady:.3f} ms/step with output against "
          f"{main_steady_ms:.3f} without (phase 5); wall ms of each chunk, "
          f"the NetCDF write after the one before included: "
          f"{[round(1e3 * r['wall_s'], 1) for r in ra.records]} [{card}]",
          flush=True)
    if not same_state(ck, s):
        bad.append("#3 checkpoint read back differs from the final state")
    if not nc_ok:
        bad.append("#3 last NetCDF file differs from the final state")

    # 2. split at half the horizon, resumed into the same out-dir
    r1 = cli.run(cfg.replace(sim_days=IO_SPLIT_DAYS), device=dev, out_dir=b)
    mid = os.path.join(root, "mid.npz")
    shutil.copy(os.path.join(b, "restart.npz"), mid)
    r2 = cli.run(cfg, device=dev, out_dir=b,
                 restart_from=os.path.join(b, "restart.npz"))
    steps_b = metric_steps(b)
    nb = len(r1.chunks) + len(r2.chunks)
    last_b = nc_vars(os.path.join(b, f"out_{nb - 1:04d}.nc"))
    same_nc = last_b.keys() == last.keys() and all(
        np.array_equal(last_b[k], v) for k, v in last.items())
    same = same_state(r2.state, s)
    print(f"  #3 split: {r1.steps} steps {r1.chunks}, then resumed at step "
          f"{r2.start_step} for {r2.steps} steps {r2.chunks}; final state "
          f"equal to the continuous run's bit for bit (every field, t, step, "
          f"radiation caches): {same}; metrics steps {steps_b}; last NetCDF "
          f"file equal to the continuous run's last: {same_nc} [{card}]",
          flush=True)
    if not same:
        bad.append("#3 split run differs from the continuous run: "
                   + str(state_diffs(r2.state, s)))
    if r2.start_step != r1.steps or r1.steps + r2.steps != ra.steps:
        bad.append(f"#3 resume started at {r2.start_step} and ran "
                   f"{r2.steps} steps after {r1.steps}, of {ra.steps}")
    if steps_b != sorted(set(steps_b)) or steps_b[0] != steps_a[0] \
            or steps_b[-1] != steps_a[-1] or r1.steps not in steps_b:
        bad.append(f"#3 split metrics steps {steps_b} against {steps_a}")
    if not same_nc:
        bad.append("#3 split run's last NetCDF file differs")
    shutil.rmtree(b)

    # 3. planted faults: each must break its gate
    with np.load(mid) as z:
        items = {k: z[k] for k in z.files}
    items["dpottdt_rad"] = np.zeros_like(items["dpottdt_rad"])
    zeroed = os.path.join(root, "zeroed.npz")
    np.savez(zeroed, **items)
    rz = cli.run(cfg, device=dev, restart_from=zeroed)
    broke = not same_state(rz.state, s)
    print(f"  planted fault, resume with the radiation cache zeroed: final "
          f"state differs: {broke}; max|dpott| "
          f"{float((rz.state.pott - s.pott).abs().max()):.3e} K", flush=True)
    if not broke:
        bad.append("resume with dpottdt_rad zeroed equals the sound run")
    retuned = cli.build_config(cli.make_parser().parse_args(
        MAIN_ARGV + ["--diff", "77.0"]))
    try:
        cli.run(retuned, device=dev, restart_from=mid)
        refused = "not refused"
    except ValueError as e:
        refused = str(e)
    ok = "numerics.diff_uv" in refused
    print(f"  planted fault, resume with --diff 77: refused naming "
          f"numerics.diff_uv: {ok}", flush=True)
    if not ok:
        bad.append(f"resume with --diff 77: {refused}")
    branch = os.path.join(root, "branch")
    cli.run(retuned, device=dev, restart_from=mid, force_resume=True,
            out_dir=branch, no_nc=True)
    with open(os.path.join(branch, "forced_branch.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ok = len(recs) == 1 and recs[0]["step"] == r1.steps and \
        recs[0]["mismatch"]["numerics.diff_uv"]["current"] == 77.0
    print(f"  planted fault, --force-resume with --diff 77: "
          f"forced_branch.jsonl {recs}", flush=True)
    if not ok:
        bad.append(f"forced resume recorded {recs}")

    # 4. times at #3
    path = os.path.join(root, "t3.npz")
    save_ms = host_ms(lambda: save_checkpoint(path, s, cfg))
    load_ms = host_ms(lambda: load_checkpoint(path, cfg, device=dev))
    writer = NCWriter(os.path.join(root, "nc"))
    writer.write(s, ra.grid, ra.forcing)          # constants.nc once
    nc_ms = host_ms(lambda: writer.write(s, ra.grid, ra.forcing))
    mb = os.path.getsize(path) / 1e6
    nc_mb = os.path.getsize(os.path.join(root, "nc", "out_0001.nc")) / 1e6
    print(f"  #3 io times, host ms per call (synchronised), mean of "
          f"{IO_TIMING_REPS}: save_checkpoint {save_ms:.1f} ({mb:.1f} MB), "
          f"load_checkpoint to the card {load_ms:.1f}, NCWriter.write "
          f"{nc_ms:.1f} ({nc_mb:.1f} MB) [{card}]", flush=True)


def _io4(dev, card, root, bad):
    cfg = cli.build_config(cli.make_parser().parse_args(BLOCKING_ARGV))
    c, d = os.path.join(root, "c"), os.path.join(root, "d")
    rc = cli.run(cfg, device=dev, out_dir=c, no_nc=True)
    r1 = cli.run(cfg.replace(sim_days=IO4_SPLIT_DAYS), device=dev,
                 out_dir=d, no_nc=True)
    r2 = cli.run(cfg, device=dev, out_dir=d, no_nc=True,
                 restart_from=os.path.join(d, "restart.npz"))
    same = same_state(r2.state, rc.state)
    print(f"  #4 {rc.path}: {rc.steps} steps {rc.chunks} continuous; split "
          f"{r1.steps} steps, saved from the gathered state, resumed onto "
          f"the mesh at step {r2.start_step} for {r2.steps} steps; final "
          f"state equal bit for bit: {same} [{card}]", flush=True)
    if not same:
        bad.append("#4 split run differs from the continuous run: "
                   + str(state_diffs(r2.state, rc.state)))
    if r2.start_step != r1.steps or r1.steps + r2.steps != rc.steps \
            or "sharded" not in r2.path:
        bad.append(f"#4 resume: {r2.path}, started at {r2.start_step}, "
                   f"{r2.steps} steps after {r1.steps}, of {rc.steps}")
    shutil.rmtree(d)
    path = os.path.join(c, "restart.npz")
    load_ms = host_ms(lambda: load_checkpoint(path, cfg, device=dev))
    save_ms = host_ms(lambda: save_checkpoint(path, rc.state, cfg))
    print(f"  #4 io times, host ms per call (synchronised), mean of "
          f"{IO_TIMING_REPS}: save_checkpoint {save_ms:.1f} "
          f"({os.path.getsize(path) / 1e6:.1f} MB), load_checkpoint to the "
          f"card {load_ms:.1f} [{card}]", flush=True)


VARIANTS = {
    # name: (counter, path that launches it, errors key)
    "predictor": ("predictor", "per-step", "predictor"),
    "corrector": ("corrector", "per-step", "corrector"),
    "predictor_masked": ("predictor_masked", "packed scan",
                         "predictor_masked"),
    "corrector_epilogue": ("corrector_epilogue", "packed scan",
                           "corrector_epilogue"),
}


def main() -> int:
    # ---- 1. device ----
    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "test needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"device: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    print(card, flush=True)
    phase("device", t)

    # ---- 2. build ----
    t = time.perf_counter()
    info = fs.build(force=True)
    for name, lines in ptxas_lines(info.log):
        print(f"  ptxas {name}: " + " | ".join(lines), flush=True)
    phase("build", t, f"nvcc {info.seconds:.2f}s -> {info.path}")

    # ---- 3. kernels vs plain at config #3 ----
    t = time.perf_counter()
    ci = check_inputs(dev)
    errs = check_kernels(ci)
    bad = []
    check_momentum(ci, bad)
    check_tall(dev, bad)
    noisy = noisy4(dev)
    shard_errs, shard_inputs = check_shards(noisy, dev, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    phase("check", t, "every variant agrees with its plain version at "
          f"{tuple(ci.state.u.shape)} fp32, on {TALL_NZ} levels, and on "
          "#4's shard blocks and seam strips; each planted fault breaks a "
          "bound")

    # ---- 4. timing ----
    t = time.perf_counter()
    timing = time_kernels(ci, card)
    shard_timing = time_shards(shard_inputs, card)
    del shard_inputs
    phase("timing", t)

    # ---- 5. main path: the packed scan ----
    t = time.perf_counter()
    run_cfg, res, main_counts, steady_ms = main_path(dev, card)
    phase("main", t, "config #3 through cli.run on the packed scan")

    # ---- 6. the per-step path beside it ----
    t = time.perf_counter()
    step_counts, _, _, _ = per_step_path(run_cfg, res.chunks[0], dev, card)
    phase("per-step", t, "the per-step path driven and checked; both paths "
          "agree")

    # ---- 7. where a step's time goes ----
    t = time.perf_counter()
    breakdown(run_cfg, res.state, res.grid, res.forcing, steady_ms, card)
    phase("breakdown", t)

    # ---- 8. BASELINE #4 on its mesh: the sharded packed scan ----
    t = time.perf_counter()
    sharded_counts = sharded_path(noisy, dev, card)
    phase("sharded", t, "#4 on 2x4 in one process through cli.run, both "
          "schedules against the unsharded grid; each planted fault breaks "
          "a bound")

    # ---- 9. backend='jnp' on the card ----
    t = time.perf_counter()
    backend_path(dev, card)
    phase("backend", t, "baseline 1 ran the plain path")

    # ---- 10. io: files, checkpoints and resume ----
    t = time.perf_counter()
    io_path(dev, card, steady_ms)
    phase("io", t, "#3 and #4 resumed bit for bit; each planted fault "
          "breaks its gate")

    kernels = []

    def entry(kname, source, path, launches, err, tol, tm):
        return {
            "name": f"fused_substep_{kname}", "route": "cuda",
            "source": f"climate_model_tpu_torch/kernels/csrc/{source}",
            "replaces": "climate_model_tpu/kernels/fused_substep.py:1047",
            "path": path, "launches": launches,
            # fields differ in units: the max is colp's (Pa); each field's
            # error and the largest error/bound ratio are listed beside it
            "max_abs_err": max(err.values()),
            "max_abs_err_by_field": err,
            "max_err_over_tol": max(e / tol[f] for f, e in err.items()),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None,
            # device ms of each launch of one call (profiled)
            "launch_ms": tm["launch_ms"],
            # ms and plain_ms are device time; the host's time to enqueue
            # one call
            "enqueue_ms": tm["enqueue_ms"],
            "plain_enqueue_ms": tm["plain_enqueue_ms"]}

    # a corrector with the physics epilogue also runs fused_substep.cu's
    # launches; its source is the epilogue's
    for kname, (counter, path, ekey) in VARIANTS.items():
        epi = kname == "corrector_epilogue"
        launches = (main_counts if path == "packed scan"
                    else step_counts)[counter]
        kernels.append(entry(
            kname, "physics_epilogue.cu" if epi else "fused_substep.cu",
            path, launches, errs[ekey], EPI_TOL if epi else FIELD_TOL,
            timing[kname]))
    overlap_counts = sharded_counts["overlap"]
    for kname in shard_timing:
        epi = kname.startswith("corrector")
        kernels.append(entry(
            kname, "physics_epilogue.cu" if epi else "fused_substep.cu",
            "sharded packed scan", overlap_counts[kname], shard_errs[kname],
            SHARD_EPI_TOL if epi else SHARD_TOL, shard_timing[kname]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(f"total {time.perf_counter() - T0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
