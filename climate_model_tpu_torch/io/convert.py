"""State, forcing and grid to and from dicts of NumPy arrays.

A climate model has no weights: what crosses between the JAX reference and
the port is state, forcing and grid. These functions take dicts keyed by the
reference's dataclass field names, which is what ``np.asarray`` of each leaf
of its ``State``/``Forcing``/``Grid`` gives, and build the port's
dataclasses (or go the other way). ``io/checkpoint.py`` reads and writes
its files through ``state_from_numpy`` and ``state_to_numpy``; both are
exact for fp32 and fp64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grid import Grid, round_to
from ..core.state import Forcing, State, resolve_device


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype != torch.empty((), dtype=dtype).numpy().dtype:
        a = a.astype(np.float64)     # cast once, by torch, to the dtype
    elif not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a).to(device, dtype)


def state_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> State:
    dev = resolve_device(device)
    kw = {f.name: _tensor(d[f.name], dev, dtype)
          for f in dataclasses.fields(State) if f.name != "step"}
    return State(step=int(np.asarray(d["step"])), **kw)


def forcing_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> Forcing:
    dev = resolve_device(device)
    return Forcing(**{f.name: _tensor(d[f.name], dev, dtype)
                      for f in dataclasses.fields(Forcing)})


def grid_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> Grid:
    """``nx``/``ny``/``nz`` default to the array shapes; ``ptop`` is
    required (a static field of the reference's Grid, not a leaf)."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(Grid):
        if f.name in ("nx", "ny", "nz", "ptop"):
            continue
        if f.name in ("dy", "dt"):
            kw[f.name] = round_to(float(np.asarray(d[f.name])), dtype)
        else:
            kw[f.name] = _tensor(d[f.name], dev, dtype)
    nz = int(d.get("nz", kw["dsigma"].shape[0]))
    ny = int(d.get("ny", kw["lat"].shape[0]))
    nx = int(d.get("nx", kw["lon"].shape[0]))
    return Grid(nx=nx, ny=ny, nz=nz, ptop=float(d["ptop"]), **kw)


def state_to_numpy(state: State) -> dict:
    out = {f.name: getattr(state, f.name).detach().cpu().numpy()
           for f in dataclasses.fields(State) if f.name != "step"}
    out["step"] = np.asarray(state.step, np.int32)
    return out
