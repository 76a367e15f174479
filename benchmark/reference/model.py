"""The benchmark's plain reference model: the port's per-step path in plain
PyTorch, frozen (``climate_model_tpu_torch/model.py::make_step_fn`` with the
plain ``step_matsuno`` at commit dbbffa0), and the host loop's rule for the
next chunk's dt (``climate_model_tpu_torch/cli.py::run``).

It imports neither ``jax`` nor ``climate_model_tpu`` nor anything of
``climate_model_tpu_torch``: grid, forcing, dt and the radiation refreshes
are worked out here again from the configuration. TF32 is switched off
where it is built (``reference_device``), though no operation here is a
matrix product.
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .grid import Grid, adaptive_cfl_dt, make_grid, round_to
from .init import initial_state_np
from .microphysics import microphysics_step
from .operators import diagnose_pressure
from .radiation import radiation_step
from .state import Forcing, State
from .stepper import step_matsuno
from .surface import surface_step
from .turbulence import turbulence_step

STATE_FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
                "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc")


def reference_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def build(cfg: ModelConfig, device, dtype) -> tuple:
    """``(grid, forcing)`` of ``cfg`` at ``dtype`` on ``device``, from the
    configuration alone."""
    _, fo_np, _ = initial_state_np(cfg)
    grid = make_grid(cfg.grid, cfg.numerics, dtype=dtype, device=device)

    def cast(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device, dtype)

    forcing = Forcing(hsurf=cast(fo_np["hsurf"]),
                      land_mask=cast(fo_np["land_mask"]),
                      albedo=cast(fo_np["albedo"]),
                      evap_eff=cast(fo_np["evap_eff"]))
    return grid, forcing


def make_state(fields: dict, t, step: int, device, dtype) -> State:
    """A State of ``fields`` (arrays or tensors) cast to ``dtype``."""
    def cast(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return State(**{f: cast(fields[f]) for f in STATE_FIELDS},
                 t=cast(t).reshape(()), step=int(step))


def step(state: State, grid: Grid, forcing: Forcing,
         cfg: ModelConfig) -> State:
    """One full model step: radiation on its interval, the Matsuno dynamics,
    then surface, turbulence and microphysics, operator split."""
    dt = grid.dt
    phys = cfg.physics
    if phys.radiation:
        state = radiation_step(state, grid, forcing, cfg)
    state = step_matsuno(state, grid, forcing, cfg)
    press = diagnose_pressure(state.colp, grid)
    if phys.surface:
        state = surface_step(state, grid, forcing, cfg, dt, press=press)
    if phys.turbulence:
        state = turbulence_step(state, grid, forcing, cfg, dt, press=press)
    if phys.microphysics:
        state = microphysics_step(state, grid, forcing, cfg, dt, press=press)
    return state.replace(t=state.t + dt, step=state.step + 1)


def run(state: State, grid: Grid, forcing: Forcing, cfg: ModelConfig,
        n_steps: int) -> State:
    for _ in range(n_steps):
        state = step(state, grid, forcing, cfg)
    return state


def max_wind(state: State) -> float:
    return float(torch.maximum(torch.max(torch.abs(state.u)),
                               torch.max(torch.abs(state.v))))


def chunk_dt(state: State, grid: Grid, cfg: ModelConfig) -> float:
    """The dt of a chunk after the first, which starts from ``state``:
    with adaptive dt the CFL bound at the state's largest wind, floored at
    5 % of the initial dt (``grid``'s) and rounded to the working dtype;
    otherwise the grid's own."""
    if not cfg.numerics.adaptive_dt:
        return grid.dt
    min_dx = min(float(torch.min(grid.dx)), grid.dy)
    dt_new = adaptive_cfl_dt(min_dx, cfg.numerics.cfl, max_wind(state))
    dt_new = max(dt_new, 0.05 * grid.dt)
    return round_to(dt_new, state.dtype)
