"""Chip smoke test of the PyTorch/CUDA port (climate_model_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds; any failure raises
and exits non-zero:

1. device  -- a CUDA device or raise; its name, count and power limit;
2. build   -- every kernel built from csrc/ with one nvcc call; the -Xptxas -v
              register, shared-memory and spill lines of each kernel;
3. check   -- BASELINE config #3 (360x180x32, fp32, full physics), 10 plain
              steps from the initial state, then the predictor and corrector
              kernels held against the plain substep on the same inputs,
              field by field, within the stated bounds; the kernels launched
              with one term left out must break them;
4. timing  -- CUDA events over 50 back-to-back launches of each kernel and
              each plain substep, beside the byte bound of the card;
5. main    -- the run command of config #3 (``run --baseline 3 --days 0.1
              --out-every-hours 1``: ~253 steps in three chunks, adaptive dt,
              hourly radiation) with the launch counters set to 0 just before
              and read just after; its launches, cadence, dt and fields are
              checked. Nothing is written to disk;
6. breakdown -- each layer of a step (radiation, the two kernels, the
              physics splits, the chunk diagnostics) timed alone.

The line before last is the total, the last line the JSON verdict. The port
imports no JAX, and neither does this script.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch

from climate_model_tpu_torch import cli
from climate_model_tpu_torch.core.config import baseline_config
from climate_model_tpu_torch.core.grid import adaptive_cfl_dt, round_to
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.dycore.stepper import step_matsuno
from climate_model_tpu_torch.kernels import fused_substep as fs
from climate_model_tpu_torch.model import make_step_fn
from climate_model_tpu_torch.physics import radiation

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
# break a bound (PLANTED_FAULTS).
FIELD_TOL = {"u": 5e-4, "v": 1e-4, "pott": 1.5e-4, "qv": 5e-9, "qc": 1e-10,
             "colp": 0.03}
PLANTED_FAULTS = {"with_rad=False": {"with_rad": False},
                  "with_diff=False": {"with_diff": False}}

# Main-path sanity bounds (the repo's verification recipe for a short run):
MAX_WIND = 100.0                 # m/s; beyond it the run is blowing up
MEAN_COLP = (90_000.0, 91_000.0)  # Pa, area-weighted mean COLP
POTT_RANGE = (280.0, 340.0)      # K, every cell
MASS_DRIFT = 1e-6                # relative drift of sum(colp*area)

# Card peaks for the bound (H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Floating-point operations per grid point of one substep, counted from
# csrc/fused_substep.cu and rounded up (column scans incl. one powf per
# level ~35, three scalar advections ~135, two momentum equations ~140,
# on-the-fly face fluxes ~40).
FLOPS_PER_POINT = 350

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


def ptxas_lines(log: str):
    """(kernel, lines) for each kernel in nvcc's -Xptxas -v output."""
    kernels, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            if "column_kernel" in mangled:
                name = "column_kernel"
            elif "point_kernelILb1" in mangled:
                name = "point_kernel<same_base=true>"
            elif "point_kernelILb0" in mangled:
                name = "point_kernel<same_base=false>"
            else:
                name = mangled
            cur = (name, [])
            kernels.append(cur)
        elif cur and ("registers" in line or "spill" in line
                      or "smem" in line):
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


def field_errors(got, want) -> dict:
    """max|got - want| of each field in FIELD_TOL; raises on a non-finite
    field of ``got``."""
    per = {}
    for f in FIELD_TOL:
        a, b = getattr(got, f), getattr(want, f)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {f} from the kernel")
        per[f] = float((a - b).abs().max())
    return per


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def substep_bound_ms(ev, base, grid, forcing, out):
    """Least time for one substep: each input read once, each output written
    once, at the card's memory rate; or its operations at the fp32 rate."""
    reads = [getattr(ev, f) for f in ("u", "v", "pott", "qv", "qc", "colp",
                                      "dpottdt_rad")]
    if base is not None:
        reads += [getattr(base, f) for f in ("u", "v", "pott", "qv", "qc",
                                             "colp")]
    reads += [forcing.hsurf, fs.geo_table(grid), grid.sigma_vb, grid.dsigma]
    writes = [getattr(out, f) for f in ("u", "v", "pott", "qv", "qc", "colp")]
    t_bytes = nbytes(*reads, *writes) / PEAK_BYTES_PER_S
    t_ops = FLOPS_PER_POINT * ev.u.numel() / PEAK_FP32_FLOPS
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def breakdown(cfg, state, grid, forcing, step_ms, card):
    """Each layer of a model step timed alone on the final state of the main
    path: ms per call over back-to-back calls (CUDA events; the device's time
    where it exceeds the host's) and the host's enqueue ms per call. Their
    sum, weighted by calls per step, is set beside the measured ms/step."""
    from climate_model_tpu_torch.dycore.operators import diagnose_pressure
    from climate_model_tpu_torch.io.metrics import diagnostics
    from climate_model_tpu_torch.physics import (microphysics, surface,
                                                 turbulence)
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    dt = grid.dt
    pred = fs.predictor(state, grid, forcing, dt, **kw)
    press = diagnose_pressure(state.colp, grid)
    layers = [
        ("radiation refresh (1 step in "
         f"{cfg.physics.rad_every_steps})",
         lambda: radiation.compute_radiation(state, grid, forcing, cfg),
         1.0 / cfg.physics.rad_every_steps),
        ("predictor kernel", lambda: fs.predictor(state, grid, forcing, dt,
                                                  **kw), 1.0),
        ("corrector kernel", lambda: fs.corrector(pred, state, grid, forcing,
                                                  dt, **kw), 1.0),
        ("pressure diagnostics", lambda: diagnose_pressure(state.colp, grid),
         1.0),
        ("surface split", lambda: surface.surface_step(
            state, grid, forcing, cfg, dt, press=press), 1.0),
        ("turbulence split", lambda: turbulence.turbulence_step(
            state, grid, forcing, cfg, dt, press=press), 1.0),
        ("microphysics split", lambda: microphysics.microphysics_step(
            state, grid, forcing, cfg, dt, press=press), 1.0),
        ("chunk diagnostics (1 per chunk)",
         lambda: diagnostics(state, grid, forcing, cfg),
         1.0 / 105),
    ]
    per_step = 0.0
    for name, fn, share in layers:
        dev_ms = timed(fn, n=20, warmup=3)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = 1e3 * (time.perf_counter() - h0) / 20
        torch.cuda.synchronize()
        per_step += share * dev_ms
        print(f"  {name}: back-to-back {dev_ms:.4f} ms, host enqueue "
              f"{host_ms:.4f} ms per call", flush=True)
    print(f"  layers summed per step: {per_step:.3f} ms, against "
          f"{step_ms:.3f} ms/step measured [{card}]", flush=True)


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
    cfg = baseline_config(3)
    state, forcing, grid = initialize(cfg, device=dev)
    plain_step = make_step_fn(cfg, dynamics=functools.partial(step_matsuno,
                                                              cfg=cfg))
    for _ in range(10):
        state = plain_step(state, grid, forcing)
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    dt = grid.dt
    pred_plain = fs.fused_substep_plain(state, None, grid, forcing, dt, **kw)
    corr_plain = fs.fused_substep_plain(pred_plain, state, grid, forcing, dt,
                                        **kw)

    def launch(kname, **over):
        if kname == "predictor":
            return fs.predictor(state, grid, forcing, dt, **dict(kw, **over))
        return fs.corrector(pred_plain, state, grid, forcing, dt,
                            **dict(kw, **over))

    want = {"predictor": pred_plain, "corrector": corr_plain}
    pred_k, corr_k = launch("predictor"), launch("corrector")
    errs, bad = {}, []
    for kname, got in (("predictor", pred_k), ("corrector", corr_k)):
        errs[kname] = field_errors(got, want[kname])
        print(f"  {kname} max|kernel-plain|: " + ", ".join(
            f"{f} {e:.3e} (<= {FIELD_TOL[f]:.1e})"
            for f, e in errs[kname].items()), flush=True)
        bad += [f"{kname}: max|kernel-plain| of {f} = {e:.3e} > "
                f"{FIELD_TOL[f]:.1e}" for f, e in errs[kname].items()
                if not e <= FIELD_TOL[f]]
    # the bounds must fail a kernel that leaves out a term
    for fault, over in PLANTED_FAULTS.items():
        for kname in ("predictor", "corrector"):
            per = field_errors(launch(kname, **over), want[kname])
            broken = [f for f, e in per.items() if e > FIELD_TOL[f]]
            print(f"  planted fault {kname} {fault}: " + ", ".join(
                f"{f} {e:.3e}{' (over)' if f in broken else ''}"
                for f, e in per.items()), flush=True)
            if not broken:
                bad.append(f"{kname} with {fault} stays within every bound: "
                           "the bounds cannot tell a kernel that drops a term")
    if bad:
        raise AssertionError("; ".join(bad))
    phase("check", t, "predictor and corrector agree with the plain substep "
          f"at {tuple(state.u.shape)} fp32; each planted fault breaks a bound")

    # ---- 4. timing ----
    t = time.perf_counter()
    calls = {
        "predictor": (lambda: fs.predictor(state, grid, forcing, dt, **kw),
                      lambda: fs.fused_substep_plain(state, None, grid,
                                                     forcing, dt, **kw),
                      None, pred_k),
        "corrector": (lambda: fs.corrector(pred_plain, state, grid, forcing,
                                           dt, **kw),
                      lambda: fs.fused_substep_plain(pred_plain, state, grid,
                                                     forcing, dt, **kw),
                      state, corr_k),
    }
    timing = {}
    for kname, (kern, plain, base, out) in calls.items():
        # in turns: kernel, plain, plain, kernel
        k1, p1, p2, k2 = timed(kern), timed(plain), timed(plain), timed(kern)
        ev = state if kname == "predictor" else pred_plain
        bound, by = substep_bound_ms(ev, base, grid, forcing, out)
        ms, plain_ms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
        timing[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by)
        print(f"  {kname}: kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
              f"{plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}), bound {bound:.4f} ms "
              f"({by}; {100 * bound / ms:.1f}% of it); no PyTorch library "
              f"call computes this substep (library_ms null) [{card}]",
              flush=True)
    phase("timing", t)

    # ---- 5. main path ----
    t = time.perf_counter()
    args = cli.make_parser().parse_args(MAIN_ARGV)
    run_cfg = cli.build_config(args)
    fs.predictor.launches = 0
    fs.corrector.launches = 0
    radiation.radiation_step.refreshes = 0
    res = cli.run(run_cfg, device=args.device)
    launches = {"predictor": fs.predictor.launches,
                "corrector": fs.corrector.launches}
    refreshes = radiation.radiation_step.refreshes
    s = res.state
    if res.aborted:
        raise AssertionError("the run aborted on a non-finite state")
    if launches != {"predictor": res.steps, "corrector": res.steps}:
        raise AssertionError(f"launches {launches} for {res.steps} steps: "
                             "expected one predictor and one corrector a step")
    every = run_cfg.physics.rad_every_steps
    want_ref = sum(1 for k in range(res.steps) if k % every == 0)
    if refreshes != want_ref:
        raise AssertionError(f"radiation refreshed {refreshes} times in "
                             f"{res.steps} steps, expected {want_ref} "
                             f"(every {every})")
    if len(res.chunks) < 3:
        raise AssertionError(f"chunks {res.chunks}: expected three")
    dt0 = res.dts[0]
    if dt0 != grid.dt:
        raise AssertionError(f"first dt {dt0} != the grid's {grid.dt}")
    for rec, dt_next in zip(res.records[:-1], res.dts[1:]):
        want = round_to(max(adaptive_cfl_dt(res.min_dx, run_cfg.numerics.cfl,
                                            rec["max_wind"]), 0.05 * dt0),
                        torch.float32)
        if dt_next != want:
            raise AssertionError(f"dt {dt_next} != adaptive_cfl_dt {want}")
    horizon = run_cfg.sim_days * 86400.0
    if abs(float(s.t) - horizon) > 0.5 * res.dts[-1]:
        raise AssertionError(f"t = {float(s.t)} s misses the horizon "
                             f"{horizon} s")
    for f in ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
              "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc"):
        if not bool(torch.isfinite(getattr(s, f)).all()):
            raise AssertionError(f"non-finite {f} after the run")
    max_wind = max(float(s.u.abs().max()), float(s.v.abs().max()))
    area = res.grid.area.double()[:, None]
    w = area / area.sum() / s.colp.shape[-1]
    mean_colp = float((s.colp.double() * w).sum())
    pott_lo, pott_hi = float(s.pott.min()), float(s.pott.max())
    s0, _, _ = initialize(run_cfg, device=dev)
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
    points = run_cfg.grid.nx * run_cfg.grid.ny * run_cfg.grid.nz
    steady_steps = sum(res.chunks[1:])
    steady_wall = sum(r["wall_s"] for r in res.records[1:])
    print(f"  {res.steps} steps {res.chunks} in {res.wall_s:.3f}s: "
          f"{1e3 * res.wall_s / res.steps:.3f} ms/step "
          f"({points * res.steps / res.wall_s / 1e6:.2f} M grid-points/s); "
          f"after the first chunk {1e3 * steady_wall / steady_steps:.3f} "
          f"ms/step ({points * steady_steps / steady_wall / 1e6:.2f} "
          f"M grid-points/s); dt {res.dts}; launches {launches}; radiation "
          f"refreshes {refreshes} [{card}]", flush=True)
    phase("main", t, "config #3 through cli.run with the substep kernels")

    # ---- 6. where a step's time goes ----
    t = time.perf_counter()
    breakdown(run_cfg, s, res.grid, res.forcing, 1e3 * steady_wall
              / steady_steps, card)
    phase("breakdown", t)

    kernels = []
    for kname in ("predictor", "corrector"):
        tm = timing[kname]
        kernels.append({
            "name": f"fused_substep_{kname}", "route": "cuda",
            "source": "climate_model_tpu_torch/kernels/csrc/fused_substep.cu",
            "replaces": "climate_model_tpu/kernels/fused_substep.py:1047",
            "launches": launches[kname],
            # fields differ in units: the max is colp's (Pa); each field's
            # error and the largest error/bound ratio are listed beside it
            "max_abs_err": max(errs[kname].values()),
            "max_abs_err_by_field": errs[kname],
            "max_err_over_tol": max(e / FIELD_TOL[f]
                                    for f, e in errs[kname].items()),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(f"total {time.perf_counter() - T0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
