"""Stability probe: long-run blow-up detection.

Port of ``climate_model_tpu/bench/stability.py``. ``probe_stability``
advances a config in chunks (``model.py::make_run_fn``) and reports the
max-wind trajectory and the first chunk, if any, where the state goes
non-finite or a wind exceeds ``wind_limit``. Each chunk's fields are fetched
to the host, which is its only synchronisation. It runs on whatever backend
the config selects and on ``device``: the CPU for cheap sweeps, the card
with the kernels for production checks.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def probe_stability(cfg, steps: int = 2000, chunk: int = 100,
                    wind_limit: float = 300.0, verbose: bool = True,
                    device="cuda") -> dict:
    """Run ``cfg`` for ``steps`` steps, watching for blow-up.

    Returns a dict with the per-chunk max-wind trajectory, the blow-up step
    (None if the run stayed bounded), and the config's diffusion settings.
    """
    from ..core.init import initialize
    from ..model import make_run_fn

    run = make_run_fn(cfg, chunk, donate=False)   # refuses before allocating
    state, forcing, grid = initialize(cfg, device=device)
    dt = float(grid.dt)

    trajectory = []
    blowup_step: Optional[int] = None
    t0 = time.time()
    done = 0
    while done < steps:
        state = run(state, grid, forcing)
        done += chunk
        u = state.u.cpu().numpy()
        v = state.v.cpu().numpy()
        pott = state.pott.cpu().numpy()
        max_u = float(np.abs(u).max())
        max_v = float(np.abs(v).max())
        jmax = np.unravel_index(np.abs(v).argmax(), v.shape)
        rec = dict(step=done, t_days=done * dt / 86400.0,
                   max_u=max_u, max_v=max_v,
                   v_argmax_kji=[int(x) for x in jmax],
                   pott_min=float(pott.min()), pott_max=float(pott.max()))
        trajectory.append(rec)
        if verbose:
            print(f"step {done:6d} t={rec['t_days']:7.3f}d "
                  f"max|u| {max_u:9.3f} max|v| {max_v:9.3f} "
                  f"at k={jmax[0]} j={jmax[1]} i={jmax[2]} "
                  f"pott [{rec['pott_min']:7.1f},{rec['pott_max']:7.1f}]",
                  flush=True)
        if not np.isfinite(max_u) or max_u > wind_limit \
                or not np.isfinite(max_v) or max_v > wind_limit:
            blowup_step = done
            break
    num = cfg.numerics
    return dict(metric="stability", steps_run=done, steps_target=steps,
                dt=dt, blowup_step=blowup_step,
                stable=blowup_step is None,
                diff_uv=num.diff_uv, diff_pott=num.diff_pott,
                diff_moist=num.diff_moist,
                grid=[cfg.grid.nx, cfg.grid.ny, cfg.grid.nz],
                wall_s=time.time() - t0, trajectory=trajectory)
