"""Command-line entry point.

Port of the single-device ``run`` path of ``climate_model_tpu/cli.py``: build
grid, state and forcing, step in chunks sized to the output cadence, fetch
the diagnostics once per chunk, recompute dt per chunk with ``--adaptive-dt``
and land exactly on the horizon. Nothing is written to disk yet: output
directories, restarts, NetCDF, TOML namelists, device meshes and the
``bench``/``plot``/``profile`` subcommands raise "not ported yet".

Usage:
  python -m climate_model_tpu_torch run --baseline 3 --days 0.1 --out-every-hours 1
  python -m climate_model_tpu_torch run --nx 64 --ny 32 --nz 8 --physics all --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import torch

from .core.config import (GridConfig, ModelConfig, NumericsConfig,
                          PhysicsConfig, baseline_config, resolve_rad_interval)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def build_config(args) -> ModelConfig:
    if getattr(args, "config", None):
        _not_ported("--config (TOML namelists, core/namelist.py)")
    if args.baseline:
        cfg = baseline_config(args.baseline)
    else:
        phys_on = args.physics == "all"
        cfg = ModelConfig(
            grid=GridConfig(nx=args.nx, ny=args.ny, nz=args.nz),
            physics=PhysicsConfig(
                microphysics=phys_on or "mic" in args.physics,
                radiation=phys_on or "rad" in args.physics,
                surface=phys_on or "srf" in args.physics,
                turbulence=phys_on or "turb" in args.physics),
            numerics=NumericsConfig(time_stepping=args.stepper),
        )
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.days is not None:
        cfg = cfg.replace(sim_days=args.days)
    if args.out_every_hours is not None:
        cfg = cfg.replace(out_every_hours=args.out_every_hours)
    if args.diff is not None:
        cfg = cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, diff_uv=args.diff, diff_pott=args.diff,
            diff_moist=args.diff))
    if args.adaptive_dt:
        cfg = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                       adaptive_dt=True))
    if args.convection:
        cfg = cfg.replace(physics=dataclasses.replace(cfg.physics,
                                                      convection=True))
    if args.topo:
        cfg = cfg.replace(topo=args.topo)
    return resolve_rad_interval(cfg)


@dataclasses.dataclass
class RunResult:
    """What a run did: the final state and what the chunk loop decided."""

    state: object                 # final State
    grid: object                  # final Grid (carries the last dt)
    forcing: object
    steps: int                    # steps taken
    chunks: List[int]             # steps per chunk
    dts: List[float]              # dt used by each chunk [s]
    records: List[dict]           # the step-line record of each chunk
    wall_s: float                 # wall time of the chunk loop [s]
    min_dx: float                 # the CFL length adaptive dt uses [m]
    aborted: bool = False         # a non-finite state stopped the run


def run(cfg: ModelConfig, device="cuda") -> RunResult:
    """Run ``cfg`` for ``cfg.sim_days`` on one device (the single-device
    branch of the reference's ``cmd_run``)."""
    from .core.grid import adaptive_cfl_dt, round_to
    from .core.init import initialize
    from .io.metrics import MetricsLogger, diagnostics
    from .model import make_chunk_runner

    if cfg.sharding.mesh_lat * cfg.sharding.mesh_lon > 1:
        _not_ported("a device mesh (dist/)")
    state, forcing, grid = initialize(cfg, device=device)
    dtype = state.dtype
    dt = grid.dt
    n_total = max(int(cfg.sim_days * 86400.0 / dt), 1)
    chunk = min(max(int(cfg.out_every_hours * 3600.0 / dt), 1), n_total)
    gc = cfg.grid
    logger = MetricsLogger(grid_points=gc.nx * gc.ny * gc.nz)
    min_dx = min(float(torch.min(grid.dx)), grid.dy)

    dev = state.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"grid {gc.nx}x{gc.ny}x{gc.nz}  dt={dt:.1f}s  steps={n_total}  "
          f"chunk={chunk}  device={dev} ({name})", flush=True)
    t0 = time.time()
    done = 0
    logger._t_last = t0
    adaptive = cfg.numerics.adaptive_dt
    horizon = cfg.sim_days * 86400.0
    chunks, dts, records = [], [], []
    t_now = 0.0

    def more():
        # adaptive: end within half a step of the horizon
        return (t_now < horizon - 0.5 * grid.dt) if adaptive \
            else (done < n_total)

    aborted = False
    while more():
        if adaptive:
            left = round((horizon - t_now) / grid.dt)
            n = min(chunk, max(1, left))
        else:
            n = min(chunk, n_total - done)
        chunks.append(n)
        dts.append(grid.dt)
        state = make_chunk_runner(cfg, n)(state, grid, forcing)
        diag = diagnostics(state, grid, forcing, cfg)
        t_now = diag.t
        done += n
        rec = logger.log_chunk(diag, extra={"dt": grid.dt} if adaptive
                               else None)
        records.append(rec)
        if rec["nan"]:
            print("!! non-finite state detected; aborting", flush=True)
            aborted = True
            break
        if adaptive:
            dt_new = adaptive_cfl_dt(min_dx, cfg.numerics.cfl,
                                     rec["max_wind"])
            dt_new = max(dt_new, 0.05 * dt)   # floor against a wind spike
            grid = grid.replace(dt=round_to(dt_new, dtype))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    gps = gc.nx * gc.ny * gc.nz * done / wall
    print(f"done: {done} steps in {wall:.1f}s  ({gps/1e6:.2f} M grid-points/s)",
          flush=True)
    return RunResult(state=state, grid=grid, forcing=forcing, steps=done,
                     chunks=chunks, dts=dts, records=records, wall_s=wall,
                     min_dx=min_dx, aborted=aborted)


def cmd_run(args) -> int:
    for flag, what in (("out_dir", "--out-dir (NetCDF output, restarts)"),
                       ("restart_from", "--restart-from (checkpoints)"),
                       ("restart_every_days", "--restart-every-days"),
                       ("topo_file", "--topo-file (io/topo.py)"),
                       ("mesh_lat", "--mesh-lat (dist/)"),
                       ("mesh_lon", "--mesh-lon (dist/)")):
        if getattr(args, flag):
            _not_ported(what)
    result = run(build_config(args), device=args.device)
    return 2 if result.aborted else 0


def _cmd_not_ported(args) -> int:
    _not_ported(f"the '{args.cmd}' subcommand")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="climate_model_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a simulation")
    pr.add_argument("--config", default=None,
                    help="TOML namelist (not ported yet)")
    pr.add_argument("--baseline", type=int, default=0,
                    help="BASELINE.md milestone config 1..5")
    pr.add_argument("--nx", type=int, default=64)
    pr.add_argument("--ny", type=int, default=32)
    pr.add_argument("--nz", type=int, default=8)
    pr.add_argument("--physics", default="none",
                    help="'none', 'all', or comma list of mic,rad,srf,turb")
    pr.add_argument("--stepper", default="matsuno",
                    choices=["matsuno", "euler", "rk4"])
    pr.add_argument("--days", type=float, default=None)
    pr.add_argument("--dtype", default=None)
    pr.add_argument("--out-every-hours", type=float, default=None,
                    help="chunk (step-line) cadence [h]")
    pr.add_argument("--diff", type=float, default=None,
                    help="override all horizontal-diffusion coefficients")
    pr.add_argument("--adaptive-dt", action="store_true",
                    help="recompute dt per chunk from CFL and the max wind")
    pr.add_argument("--convection", action="store_true",
                    help="enable the moist-convective mixing guard")
    pr.add_argument("--topo", default=None,
                    choices=["gaussian_mountain", "aquaplanet", "continents"])
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "version of every kernel)")
    for flag in ("--out-dir", "--restart-from", "--restart-every-days",
                 "--topo-file"):
        pr.add_argument(flag, default=None, help="not ported yet")
    pr.add_argument("--mesh-lat", type=int, default=0, help="not ported yet")
    pr.add_argument("--mesh-lon", type=int, default=0, help="not ported yet")
    pr.set_defaults(fn=cmd_run)

    for name in ("bench", "plot", "profile"):
        sp = sub.add_parser(name, help="not ported yet")
        sp.set_defaults(fn=_cmd_not_ported)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
