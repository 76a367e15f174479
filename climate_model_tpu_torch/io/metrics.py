"""Chunk diagnostics and the host-side step line.

Port of ``climate_model_tpu/io/metrics.py``: the diagnostics are computed on
the device once per chunk and fetched in one transfer; ``MetricsLogger``
prints the step line and appends the same record, with the reference's
keys, to a JSONL file. A sharded run computes them on its gathered global state, on every rank:
global sums, and the maximum wind over every shard, from which each rank takes
the same adaptive dt. Only rank 0 prints.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import torch

from ..core import constants as c
from ..core.grid import Grid
from ..core.state import State


class StepDiagnostics(NamedTuple):
    """Chunk diagnostics, host floats (see the reference for each field)."""

    t: float
    step: int
    max_wind: float
    mean_colp: float
    mean_tair_proxy: float
    total_water: float
    nan_flag: bool
    toa_net_sw: float
    olr: float
    energy: float
    evap_rate: float
    total_rain: float
    pw: float


def diagnostics(state: State, grid: Grid, forcing=None,
                cfg=None) -> StepDiagnostics:
    area = grid.area[:, None]
    w = area / torch.sum(area) / state.colp.shape[-1]
    mean_colp = torch.sum(state.colp * w)
    dsig = grid.dsigma[:, None, None]
    mass = state.colp[None] * dsig
    mean_pott = torch.sum(state.pott * mass * w[None]) \
        / torch.sum(mass * w[None])
    water = torch.sum((state.qv + state.qc) * mass * area[None]) / c.G \
        + torch.sum(state.rain * area)
    max_wind = torch.maximum(torch.max(torch.abs(state.u)),
                             torch.max(torch.abs(state.v)))
    finite = torch.isfinite(state.u).all() & torch.isfinite(state.colp).all() \
        & torch.isfinite(state.pott).all() & torch.isfinite(state.qv).all()

    zero = torch.zeros_like(state.t)
    toa_net_sw = olr = energy = evap_rate = zero
    total_rain = torch.sum(state.rain * w)
    pw = torch.sum((state.qv + state.qc) * mass * w[None]) / c.G
    if forcing is not None and cfg is not None:
        from ..dycore.operators import diagnose_pressure
        press = diagnose_pressure(state.colp, grid)
        if cfg.physics.radiation:
            from ..physics.radiation import compute_radiation
            rad = compute_radiation(state, grid, forcing, cfg)
            toa_net_sw = torch.sum(rad.swflx_toa * w)
            olr = torch.sum(rad.olr * w)
        if cfg.physics.surface:
            from ..physics.surface import surface_fluxes
            fx = surface_fluxes(state, grid, forcing, cfg, press=press)
            evap_rate = torch.sum(fx.evap * w)
        tair = state.pott * press[1]
        col = torch.sum((c.C_P * tair + c.L_V * state.qv) * mass, dim=0) / c.G
        heat_cap = torch.where(
            forcing.land_mask > 0.5,
            torch.full_like(state.tsurf, cfg.physics.soil_heat_capacity),
            torch.full_like(state.tsurf, cfg.physics.ocean_heat_capacity))
        energy = torch.sum((col + heat_cap * state.tsurf) * w)

    vals = torch.stack([state.t, max_wind, mean_colp, mean_pott, water,
                        (~finite).to(state.t.dtype), toa_net_sw, olr, energy,
                        evap_rate, total_rain, pw]).tolist()
    (t, max_wind, mean_colp, mean_pott, water, nan, toa_net_sw, olr, energy,
     evap_rate, total_rain, pw) = vals
    return StepDiagnostics(
        t=t, step=state.step, max_wind=max_wind, mean_colp=mean_colp,
        mean_tair_proxy=mean_pott, total_water=water, nan_flag=nan != 0.0,
        toa_net_sw=toa_net_sw, olr=olr, energy=energy,
        evap_rate=evap_rate, total_rain=total_rain, pw=pw)


def _free_suffix(path: str) -> str:
    """``path.1``, or the first of ``path.2``, ``path.3``, ... not taken."""
    n = 1
    while os.path.exists(f"{path}.{n}"):
        n += 1
    return f"{path}.{n}"


@dataclasses.dataclass
class MetricsLogger:
    """Host-side step line and JSONL record, one per chunk (silent and with
    no file with ``quiet`` and no ``jsonl_path``: the ranks other than 0 of
    a sharded run)."""

    jsonl_path: Optional[str] = None
    grid_points: int = 0
    quiet: bool = False
    _t_last: float = dataclasses.field(default_factory=time.time)
    _step_last: int = 0

    def begin_session(self, resume_step: int = 0):
        """Make the JSONL file read as one timeline with monotone steps. A
        fresh run (``resume_step`` 0) moves a non-empty file aside to the
        first free ``.1``, ``.2``, ... (the reference always takes ``.1``
        and so overwrites an older rotation) and leaves an empty one; a
        resume drops the lines past the resume step, an earlier session's
        superseded future."""
        if not (self.jsonl_path and os.path.exists(self.jsonl_path)):
            return
        if resume_step <= 0:
            if os.path.getsize(self.jsonl_path) > 0:
                rotated = _free_suffix(self.jsonl_path)
                os.replace(self.jsonl_path, rotated)
                if not self.quiet:
                    print(f"note: previous run's {self.jsonl_path} rotated "
                          f"to {rotated}", flush=True)
            return
        kept = []
        with open(self.jsonl_path) as f:
            for line in f:
                try:
                    if json.loads(line).get("step", 0) > resume_step:
                        break
                except json.JSONDecodeError:
                    break
                kept.append(line)
        with open(self.jsonl_path, "w") as f:
            f.writelines(kept)

    def log_chunk(self, d: StepDiagnostics, extra: dict | None = None):
        now = time.time()
        step = int(d.step)
        wall = now - self._t_last
        nsteps = max(step - self._step_last, 1)
        gps = self.grid_points * nsteps / wall if wall > 0 else 0.0
        rec = dict(
            step=step, t_days=d.t / 86400.0,
            max_wind=d.max_wind, mean_colp=d.mean_colp,
            mean_pott=d.mean_tair_proxy, total_water=d.total_water,
            nan=bool(d.nan_flag), wall_s=wall, grid_points_per_s=gps,
            toa_net_sw=d.toa_net_sw, olr=d.olr, energy=d.energy,
            evap_rate=d.evap_rate, total_rain=d.total_rain, pw=d.pw,
        )
        if extra:
            rec.update(extra)
        if not self.quiet:
            print(f"step {step:7d}  day {rec['t_days']:8.3f}  "
                  f"max|V| {rec['max_wind']:7.2f} m/s  "
                  f"COLP {rec['mean_colp']:9.1f} Pa  "
                  f"POTT {rec['mean_pott']:7.2f} K  "
                  f"{gps/1e6:8.2f} Mgp/s", flush=True)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        self._t_last = now
        self._step_last = step
        return rec
