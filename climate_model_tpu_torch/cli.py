"""Command-line entry point.

Port of ``climate_model_tpu/cli.py``'s ``run`` and ``plot``: build grid,
state and forcing (or resume from a checkpoint and run only the remainder),
step in chunks sized to the output cadence, fetch the diagnostics once per
chunk, recompute dt per chunk with ``--adaptive-dt`` and land exactly on the
horizon. With ``--out-dir`` a run writes a NetCDF snapshot after each chunk
(unless ``--no-nc``), one JSONL metrics line a chunk, a checkpoint at the
restart cadence and one at the end. The chunks run ``model.py::
make_chunk_runner``: for ``backend='pallas'`` the packed scan, whose
corrector kernel carries the physics as its epilogue, and on a device mesh
its sharded form, whose blocks stay split across chunks and are gathered
for the diagnostics and the files; for ``backend='jnp'`` the plain PyTorch
per-step path, on any device. Not ported yet: a mesh with
``backend='jnp'`` and the ``bench`` and ``profile`` subcommands, which
raise "not ported yet".

Usage:
  python -m climate_model_tpu_torch run --baseline 3 --days 0.1 --out-every-hours 1 --out-dir out3
  python -m climate_model_tpu_torch run --baseline 3 --days 0.2 --out-every-hours 1 --out-dir out3 --restart-from out3/restart.npz
  python -m climate_model_tpu_torch run --baseline 4 --days 0.05 --halo-overlap
  python -m climate_model_tpu_torch run --config configs/baseline_1.toml --device cpu
  python -m climate_model_tpu_torch plot out3/out_0002.nc
  torchrun --nproc-per-node 4 -m climate_model_tpu_torch run --multihost \
      --device cpu --nx 32 --ny 16 --nz 8 --physics all --dtype float64 \
      --backend pallas --mesh-lat 2 --mesh-lon 2 --halo-overlap
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List

import torch
import torch.distributed as tdist

from .core.config import (GridConfig, ModelConfig, NumericsConfig,
                          PhysicsConfig, baseline_config, resolve_rad_interval)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def build_config(args) -> ModelConfig:
    if args.config:
        from .core.namelist import load_config
        cfg = load_config(args.config)
    elif args.baseline:
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
    if args.restart_every_days is not None:
        cfg = cfg.replace(restart_every_days=args.restart_every_days)
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
    if args.topo_file:
        cfg = cfg.replace(topo_file=args.topo_file)
    if args.backend_override:
        cfg = cfg.replace(backend=args.backend_override)
    sh = cfg.sharding
    if args.mesh_lat or args.mesh_lon:
        # 1x1 overrides a preset's mesh: its grid on one device
        sh = dataclasses.replace(sh, mesh_lat=args.mesh_lat or sh.mesh_lat,
                                 mesh_lon=args.mesh_lon or sh.mesh_lon)
    if args.sharding_mode:
        sh = dataclasses.replace(sh, mode=args.sharding_mode)
    if args.halo_overlap:
        sh = dataclasses.replace(sh, halo_overlap=True)
    return resolve_rad_interval(cfg.replace(sharding=sh))


@dataclasses.dataclass
class RunResult:
    """What a run did: the final state and what the chunk loop decided."""

    state: object                 # final State
    grid: object                  # final Grid (carries the last dt)
    forcing: object
    start_step: int               # the step it started from (0, or resumed)
    steps: int                    # steps taken
    chunks: List[int]             # steps per chunk
    dts: List[float]              # dt used by each chunk [s]
    records: List[dict]           # the step-line record of each chunk
    wall_s: float                 # wall time of the chunk loop [s]
    min_dx: float                 # the CFL length adaptive dt uses [m]
    path: str                     # what the chunks ran, as printed
    aborted: bool = False         # a non-finite state stopped the run


def describe_path(cfg: ModelConfig, mesh=None) -> str:
    """What ``make_chunk_runner(cfg, ...)`` runs, for the start line."""
    from .model import takes_packed_scan

    if not takes_packed_scan(cfg):
        return "per-step (plain PyTorch dynamics, backend=jnp)"
    if mesh is None:
        return "packed scan (corrector with physics epilogue)"
    sh = cfg.sharding
    schedule = ("halo overlap" if sh.halo_overlap and sh.mesh_lat > 1
                else "blocking")
    return (f"sharded packed scan  mesh={sh.mesh_lat}x{sh.mesh_lon} "
            f"({sh.mode}, {schedule}, {mesh.describe()})")


def _record_branch(out_dir: str, restart_from: str, step: int,
                   mismatch: dict):
    """Append a forced resume's provenance to ``forced_branch.jsonl``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "forced_branch.jsonl"), "a") as f:
        f.write(json.dumps(dict(
            time=time.strftime("%Y-%m-%dT%H:%M:%S"),
            restart_from=restart_from, step=step, mismatch=mismatch)) + "\n")


def run(cfg: ModelConfig, device="cuda", out_dir: str = None,
        restart_from: str = None, force_resume: bool = False,
        auto_resume: bool = False, no_nc: bool = False) -> RunResult:
    """Run ``cfg`` up to ``cfg.sim_days``: on one device, or on the mesh of
    ``cfg.sharding`` (``dist/mesh.py`` says where its shards run).

    ``restart_from`` (or, with ``auto_resume``, ``out_dir``'s own
    ``restart.npz`` where there is one) resumes from a checkpoint and runs
    only the remainder; ``force_resume`` resumes despite a config mismatch
    and records the branch in ``out_dir/forced_branch.jsonl``. With
    ``out_dir`` the run writes ``metrics.jsonl``, a NetCDF snapshot after
    each chunk (not with ``no_nc``) and ``restart.npz`` at the restart
    cadence and at the end."""
    from .core.grid import adaptive_cfl_dt, round_to
    from .core.init import initialize
    from .io.checkpoint import load_checkpoint_ex, save_checkpoint
    from .io.metrics import MetricsLogger, diagnostics
    from .io.netcdf import NCWriter
    from .model import make_chunk_runner

    sh = cfg.sharding
    mesh = None
    if sh.mesh_lat * sh.mesh_lon > 1:
        if cfg.backend != "pallas":
            _not_ported("a device mesh with backend='jnp' (dist/halo.py, "
                        "GSPMD 'auto'; pass --backend pallas)")
        if sh.mode != "shard_map":
            # the kernels compose with a mesh only through the explicit
            # halo exchange (the reference's cli.py:162-171)
            if not tdist.is_initialized() or tdist.get_rank() == 0:
                print("note: pallas backend on a device mesh requires "
                      "sharding mode 'shard_map'; switching mode auto -> "
                      "shard_map", flush=True)
            cfg = cfg.replace(sharding=dataclasses.replace(
                sh, mode="shard_map"))
    state, forcing, grid = initialize(cfg, device=device)
    if cfg.sharding.mesh_lat * cfg.sharding.mesh_lon > 1:
        from .dist.mesh import make_mesh, validate_divisibility
        from .dist.sharding import gather, shard
        mesh = make_mesh(cfg, device=state.device)
        validate_divisibility(cfg, mesh)
    p0 = mesh is None or mesh.rank in (None, 0)
    ckpt = os.path.join(out_dir, "restart.npz") if out_dir else None
    if (not restart_from and auto_resume and ckpt
            and (os.path.exists(ckpt) or os.path.exists(ckpt + ".p0"))):
        restart_from = ckpt        # a relaunch picks up its own checkpoint
    if restart_from:
        state, mismatch = load_checkpoint_ex(
            restart_from, cfg, force=force_resume, device=state.device)
        if p0:
            print(f"resumed from {restart_from} at step {state.step}",
                  flush=True)
            if mismatch and out_dir:
                _record_branch(out_dir, restart_from, state.step, mismatch)
    dtype = state.dtype
    dt = grid.dt
    n_total = max(int(cfg.sim_days * 86400.0 / dt), 1)
    chunk = min(max(int(cfg.out_every_hours * 3600.0 / dt), 1), n_total)
    gc = cfg.grid
    logger = MetricsLogger(
        jsonl_path=os.path.join(out_dir, "metrics.jsonl")
        if out_dir and p0 else None,
        grid_points=gc.nx * gc.ny * gc.nz, quiet=not p0)
    # a fresh run rotates an old file aside, a resume drops its future
    logger.begin_session(state.step)
    writer = NCWriter(out_dir) if out_dir and not no_nc else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    min_dx = min(float(torch.min(grid.dx)), grid.dy)

    dev = state.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    path = describe_path(cfg, mesh)
    if p0:
        print(f"grid {gc.nx}x{gc.ny}x{gc.nz}  dt={dt:.1f}s  steps={n_total}  "
              f"chunk={chunk}  device={dev} ({name})  path={path}",
              flush=True)
    # a resumed run starts from the checkpoint's step and time and runs
    # only the remainder
    start = done = state.step
    t_now = float(state.t)
    t0 = time.time()
    if mesh is not None:
        # the blocks stay split across chunks
        state = shard(mesh, state, grid, forcing)
    logger._t_last = t0
    logger._step_last = done
    restart_every = max(int(cfg.restart_every_days * 86400.0 / dt), 1)
    next_restart = (done // restart_every + 1) * restart_every
    adaptive = cfg.numerics.adaptive_dt
    horizon = cfg.sim_days * 86400.0
    chunks, dts, records = [], [], []

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
        # a sharded run's diagnostics and files are of the gathered global
        # state, the same on every rank: so is the dt taken from its wind
        whole = state if mesh is None else gather(state)
        diag = diagnostics(whole, grid, forcing, cfg)
        t_now = diag.t
        done += n
        rec = logger.log_chunk(diag, extra={"dt": grid.dt} if adaptive
                               else None)
        records.append(rec)
        if rec["nan"]:
            if p0:
                print("!! non-finite state detected; aborting", flush=True)
            aborted = True
            break
        if adaptive:
            dt_new = adaptive_cfl_dt(min_dx, cfg.numerics.cfl, diag.max_wind)
            dt_new = max(dt_new, 0.05 * dt)   # floor against a wind spike
            grid = grid.replace(dt=round_to(dt_new, dtype))
        if writer:
            writer.write(whole, grid, forcing)
        if ckpt and done >= next_restart:
            save_checkpoint(ckpt, state, cfg)
            next_restart += restart_every
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    gps = gc.nx * gc.ny * gc.nz * (done - start) / wall
    if p0:
        print(f"done: {done - start} steps in {wall:.1f}s  "
              f"({gps/1e6:.2f} M grid-points/s)", flush=True)
    if ckpt and not aborted:
        save_checkpoint(ckpt, state, cfg)
    if mesh is not None:
        state = gather(state)
    return RunResult(state=state, grid=grid, forcing=forcing,
                     start_step=start, steps=done - start, chunks=chunks,
                     dts=dts, records=records, wall_s=wall, min_dx=min_dx,
                     path=path, aborted=aborted)


def init_multihost(device) -> torch.device:
    """``torch.distributed`` from the launcher's environment (``torchrun``
    sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK): NCCL
    with one card per rank (``cuda:LOCAL_RANK``) on ``cuda``, gloo on
    ``cpu``. Returns this rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    tdist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                             init_method="env://")
    return dev


def cmd_run(args) -> int:
    cfg = build_config(args)
    kw = dict(out_dir=args.out_dir, restart_from=args.restart_from,
              force_resume=args.force_resume, auto_resume=args.auto_resume,
              no_nc=args.no_nc)
    if not args.multihost:
        return 2 if run(cfg, device=args.device, **kw).aborted else 0
    device = init_multihost(args.device)
    try:
        return 2 if run(cfg, device=device, **kw).aborted else 0
    finally:
        tdist.destroy_process_group()


def cmd_plot(args) -> int:
    from .io.plot import (quicklook_nc, quicklook_npz, timeseries_jsonl,
                          zonal_mean_npz)
    out = args.out or (args.nc.rsplit(".", 1)[0] + ".png")
    if args.nc.endswith(".jsonl"):      # run metrics -> climate time series
        print(timeseries_jsonl(args.nc, out))
        return 0
    if args.nc.endswith(".npz"):        # restart checkpoint (--no-nc runs)
        grid_cfg = None
        if args.config:
            from .core.namelist import load_config
            grid_cfg = load_config(args.config).grid
        elif args.baseline:
            grid_cfg = baseline_config(args.baseline).grid
        if args.zonal:
            print(zonal_mean_npz(args.nc, out, grid_cfg=grid_cfg))
        else:
            print(quicklook_npz(args.nc, out, level=args.level,
                                grid_cfg=grid_cfg))
    else:
        print(quicklook_nc(args.nc, out, level=args.level))
    return 0


def _cmd_not_ported(args) -> int:
    _not_ported(f"the '{args.cmd}' subcommand")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="climate_model_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a simulation")
    pr.add_argument("--config", default=None,
                    help="TOML namelist (see configs/*.toml)")
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
    pr.add_argument("--out-dir", default=None)
    pr.add_argument("--out-every-hours", type=float, default=None,
                    help="NetCDF output cadence (i_out_nth_hour analogue). "
                         "A cadence whose step-chunk divides the horizon "
                         "avoids a shorter tail chunk")
    pr.add_argument("--restart-every-days", type=float, default=None,
                    help="checkpoint cadence (i_restart_nth_day analogue)")
    pr.add_argument("--restart-from", default=None)
    pr.add_argument("--force-resume", action="store_true",
                    help="resume even if the checkpoint's config "
                         "fingerprint mismatches (branch a physics-"
                         "perturbation experiment from a common spin-up; "
                         "warns loudly instead of refusing)")
    pr.add_argument("--auto-resume", action="store_true",
                    help="resume from this out-dir's own last periodic "
                         "checkpoint if one exists (failure-recovery loop: "
                         "relaunch with identical arguments after a crash)")
    pr.add_argument("--diff", type=float, default=None,
                    help="override all horizontal-diffusion coefficients")
    pr.add_argument("--adaptive-dt", action="store_true",
                    help="recompute dt per chunk from CFL and the max wind")
    pr.add_argument("--convection", action="store_true",
                    help="enable the moist-convective mixing guard")
    pr.add_argument("--topo", default=None,
                    choices=["gaussian_mountain", "aquaplanet", "continents"],
                    help="synthetic topography/land configuration "
                         "(core/init.py; 'continents' is the procedural "
                         "Earth-like layout, land fraction ~0.28)")
    pr.add_argument("--topo-file", default=None,
                    help="NetCDF elevation file regridded to the model "
                         "grid (io/topo.py; reference ETOPO-input parity) "
                         "— overrides --topo")
    pr.add_argument("--no-nc", action="store_true",
                    help="skip NetCDF field dumps (JSONL metrics + restart "
                         "checkpoints only — e.g. when the device->host "
                         "link is slow relative to the field volume)")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "version of every kernel)")
    pr.add_argument("--backend", dest="backend_override", default=None,
                    choices=["jnp", "pallas"],
                    help="'pallas': the CUDA kernels (packed scan); 'jnp': "
                         "plain PyTorch operators on any device")
    pr.add_argument("--mesh-lat", type=int, default=0,
                    help="device-mesh latitude extent (domain "
                         "decomposition); 1x1 runs a preset's grid unsharded")
    pr.add_argument("--mesh-lon", type=int, default=0,
                    help="device-mesh longitude extent")
    pr.add_argument("--sharding-mode", default=None,
                    choices=["auto", "shard_map"],
                    help="'auto' switches to 'shard_map' with the kernels")
    pr.add_argument("--halo-overlap", action="store_true",
                    help="overlap the lat halo exchange with the main "
                         "kernels (seam strips)")
    pr.add_argument("--multihost", action="store_true",
                    help="one shard per rank: initialise torch.distributed "
                         "from the launcher's environment (NCCL on cuda, "
                         "gloo on cpu)")
    pr.set_defaults(fn=cmd_run)

    for name in ("bench", "profile"):
        sp = sub.add_parser(name, help="not ported yet")
        sp.set_defaults(fn=_cmd_not_ported)

    pl_ = sub.add_parser("plot", help="quicklook PNG from an out_XXXX.nc, "
                                      "a restart.npz checkpoint, or a "
                                      "metrics.jsonl (climate time series); "
                                      "needs matplotlib")
    pl_.add_argument("nc")
    pl_.add_argument("--out", default=None)
    pl_.add_argument("--level", type=int, default=-1)
    pl_.add_argument("--zonal", action="store_true",
                     help="zonal-mean cross-sections (u/T/q vs lat-sigma) "
                          "instead of the map quicklook (npz input)")
    pl_.add_argument("--config", default=None,
                     help="run's TOML namelist (checkpoint quicklooks: "
                          "supplies ptop + lat/lon extents)")
    pl_.add_argument("--baseline", type=int, default=0,
                     help="run's baseline preset (same purpose)")
    pl_.set_defaults(fn=cmd_plot)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
