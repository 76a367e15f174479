"""Dry-mass drift of the kernel path against the plain path.

From the initial state of BASELINE #3 over the continents (fp32), or a
checkpoint of that run (``--restart``), runs the packed scan
(``backend='pallas'``: the two CUDA kernels) and the plain per-step path
(``backend='jnp'``) for the same steps, in chunks, and reads the global
dry mass, ``sum(colp * area)`` summed in fp64, after each chunk.
In exact arithmetic the flux-form continuity keeps it; each path's drift is
its rounding. Printed for each path: the change of the area-mean COLP from
the start after each chunk (Pa), and a least-squares drift per 1000 steps
with its standard error. The plain path in fp64 (``--fp64-steps``) shows
the scheme's own drift without fp32 rounding. The last line is one JSON
object with the fits.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/mass_drift.py --steps 8000 --chunk 500 --fp64-steps 1000
    python3 tools/mass_drift.py --restart out_torch_clim_continents/restart.npz

``--device cpu`` runs the same on the CPU (the kernels' plain versions;
slow at this grid).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from climate_model_tpu_torch.core.config import baseline_config  # noqa: E402
from climate_model_tpu_torch.core.grid import (adaptive_cfl_dt,  # noqa: E402
                                               round_to)
from climate_model_tpu_torch.core.init import initialize  # noqa: E402
from climate_model_tpu_torch.io.checkpoint import load_checkpoint  # noqa: E402
from climate_model_tpu_torch.model import make_chunk_runner  # noqa: E402


# the floating-point fields of a State
FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain", "soil_moist",
          "dpottdt_rad", "swflx_sfc", "lwflx_sfc", "t")


def mean_colp(state, grid) -> float:
    """The area-mean COLP of ``state`` (Pa), summed in fp64."""
    area = grid.area.double()[:, None]
    return float((state.colp.double() * area).sum()
                 / (area.sum() * state.colp.shape[-1]))


def start(cfg, device, restart=None):
    """The initial state of ``cfg``, or the checkpoint ``restart`` at the
    config's dtype with the dt that a run takes after it (the adaptive
    rule of ``cli.run`` at the state's largest wind). Returns (state,
    forcing, grid)."""
    state, forcing, grid = initialize(cfg, device=device)
    if restart is None:
        return state, forcing, grid
    saved = load_checkpoint(restart, cfg.replace(dtype="float32"),
                            device=device)
    state = saved.replace(**{f: getattr(saved, f).to(state.dtype)
                             for f in FIELDS})
    wind = max(float(state.u.abs().max()), float(state.v.abs().max()))
    min_dx = min(float(torch.min(grid.dx)), grid.dy)
    dt = max(adaptive_cfl_dt(min_dx, cfg.numerics.cfl, wind), 0.05 * grid.dt)
    return state, forcing, grid.replace(dt=round_to(dt, torch.float32))


def drift(cfg, steps: int, chunk: int, device, restart=None) -> dict:
    """``steps`` steps of ``cfg`` from its initial state (or ``restart``)
    in chunks of ``chunk``: the change of mean COLP after each chunk and
    its fit."""
    state, forcing, grid = start(cfg, device, restart)
    run = make_chunk_runner(cfg, chunk)
    m0 = mean_colp(state, grid)
    done, xs, ys = 0, [], []
    t = time.perf_counter()
    while done < steps:
        state = run(state, grid, forcing)
        done += chunk
        xs.append(done)
        ys.append(mean_colp(state, grid) - m0)
    wall = time.perf_counter() - t
    (slope, icept), res, *_ = np.polyfit(xs, ys, 1, full=True)
    n = len(xs)
    sd = (float(np.sqrt(res[0] / (n - 2) / np.sum((np.array(xs)
                                                  - np.mean(xs)) ** 2)))
          if n > 2 and len(res) else float("nan"))
    return dict(backend=cfg.backend, dtype=cfg.dtype, steps=done, dt=grid.dt,
                mean_colp_start=m0, change=ys, per_1000=1e3 * slope,
                per_1000_se=1e3 * sd, ms_per_step=1e3 * wall / done)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--chunk", type=int, default=500)
    p.add_argument("--fp64-steps", type=int, default=1000)
    p.add_argument("--restart", default=None,
                   help="start from this checkpoint of the run (by default "
                        "the initial state)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for the CPU)")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    cfg = baseline_config(3).replace(topo="continents")
    runs = [(cfg, args.steps), (cfg.replace(backend="jnp"), args.steps),
            (cfg.replace(backend="jnp", dtype="float64"), args.fp64_steps)]
    out = []
    for c, n in runs:
        if n <= 0:
            continue
        r = drift(c, n, min(args.chunk, n), device, args.restart)
        out.append(r)
        print(f"backend={r['backend']} {r['dtype']}: {r['steps']} steps at "
              f"dt {r['dt']:.3f} s, {r['ms_per_step']:.3f} ms/step; mean "
              f"COLP {r['mean_colp_start']:.6f} Pa at the start, its change "
              f"after each chunk (Pa): "
              + " ".join(f"{y:.3e}" for y in r["change"])
              + f"; drift {r['per_1000']:.4e} +- {r['per_1000_se']:.1e} Pa "
              f"per 1000 steps [{name}]", flush=True)
    print(json.dumps({"device": name, "runs": [
        {k: v for k, v in r.items() if k != "change"} for r in out]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
