"""Op-count audit of the substep's element work.

Port of ``climate_model_tpu/bench/opcount.py``. The reference walks the
jaxpr of its Pallas kernel; the CUDA kernels have no such trace, so the
port counts the element work of the kernel's **plain version**
(``kernels/fused_substep.py::fused_substep_plain``) as it runs, under a
``TorchDispatchMode`` that sees every aten op:

  * an arithmetic op is weighted by the elements it outputs; views, copies,
    concatenations, rolls and fills are moves, counted apart (a hook that
    took them for arithmetic would inflate the total);
  * each op is labelled with the reference's term regions by the calling
    function in the port's ``dycore/`` and ``physics/`` modules (helpers
    such as the boundary shifts take their caller's region);
  * repeated ``(op, operands)`` are value-numbered: their elements are the
    redundancy, the ceiling of what common-subexpression elimination could
    save in the plain version (which is not hand-CSE'd, unlike the kernel).

It is a model of the work, not a measurement of the kernel: the CUDA
kernel keeps its intermediates in registers and shared memory and does
not do the plain version's moves. ``n_tiles`` is the launch plan's block
count (``kernels/fused_substep.py::launch_plan``), and ``fp32_floor_ms``
prices the arithmetic at the fp32 peak of an H100 SXM
(``bench/roofline.py``), one operation an element.

Run: python -m climate_model_tpu_torch.bench.opcount [--baseline 3]
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from .roofline import PEAKS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODEL_DIRS = tuple(os.path.join(_PKG, d) + os.sep
                    for d in ("dycore", "physics"))

# The calling function -> the reference's term region.
REGIONS = {
    "diagnose_pressure": "pressure/Exner diagnostics",
    "diagnose": "pressure/Exner diagnostics",
    "diagnose_geopotential": "continuity + fused hydrostatic/flux scans",
    "continuity": "continuity + fused hydrostatic/flux scans",
    "scalar_tendency": "scalar advection batch (pott|qv|qc) + diffusion",
    "momentum_tendency": "u and v momentum",
    "tendencies": "tendency switches and sources",
    "proceed": "mass-weighted update",
    "surface_fluxes": "epilogue: surface",
    "surface_step": "epilogue: surface",
    "evap_efficiency": "epilogue: surface",
    "turbulence_step": "epilogue: turbulence",
    "diffuse": "epilogue: turbulence",
    "convective_k": "epilogue: turbulence",
    "microphysics_step": "epilogue: microphysics",
    "saturation_adjustment": "epilogue: microphysics",
}
# The pressure of the new colp, computed for the epilogue outside the
# dynamics (the reference kernel's own region)
EPILOGUE_PRESSURE = "epilogue: pressure of new colp"
DYNAMICS_FRAMES = ("tendencies", "proceed", "substep")
OUTSIDE = "(outside the model's modules)"

MOVES = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "slice",
    "select", "unsqueeze", "squeeze", "permute", "transpose", "t", "clone",
    "copy", "copy_", "cat", "stack", "roll", "flip", "zeros_like",
    "ones_like", "empty_like", "full_like", "zeros", "ones", "empty",
    "full", "new_zeros", "new_ones", "new_empty", "new_full", "fill",
    "fill_", "zero_", "as_strided", "alias", "detach", "lift_fresh",
    "lift_fresh_copy", "_to_copy", "contiguous", "constant_pad_nd",
    "unbind", "split", "split_with_sizes", "narrow", "repeat",
    "scalar_tensor", "_local_scalar_dense", "index", "index_select",
    "slice_scatter", "select_scatter", "arange", "linspace", "empty_strided",
    "_unsafe_index",
}


def _region() -> str:
    """The region of the op being dispatched: the innermost frame in the
    port's dycore/ or physics/ modules whose function has a region."""
    f = sys._getframe(2)
    names = []
    while f is not None:
        if f.f_code.co_filename.startswith(_MODEL_DIRS):
            names.append(f.f_code.co_name)
        f = f.f_back
    for i, name in enumerate(names):
        if name in REGIONS:
            if name == "diagnose_pressure" and not any(
                    n in DYNAMICS_FRAMES for n in names[i + 1:]):
                return EPILOGUE_PRESSURE
            return REGIONS[name]
    return OUTSIDE


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.arith = collections.defaultdict(int)
        self.moves = collections.defaultdict(int)
        self.redundant = collections.defaultdict(int)
        self.numbers = WeakIdKeyDictionary()
        self.seen = {}

    def _operand(self, x):
        if isinstance(x, torch.Tensor):
            return self.numbers.get(x, ("in", id(x)))
        if isinstance(x, (list, tuple)):
            return tuple(self._operand(y) for y in x)
        return repr(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        key = (str(func), self._operand(args),
               tuple(sorted((k, self._operand(v))
                            for k, v in kwargs.items())))
        dup = key in self.seen
        num = self.seen.setdefault(key, len(self.seen))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for i, t in enumerate(outs):
            self.numbers[t] = (num, i)
        elems = sum(t.numel() for t in outs)
        region = _region()
        if name in MOVES or func.is_view:
            self.moves[region] += elems
        else:
            self.arith[region] += elems
            if dup:
                self.redundant[region] += elems
        return out


@dataclasses.dataclass
class Audit:
    region_elems: dict          # label -> arithmetic element-ops
    region_moves: dict          # label -> data-movement elements
    redundant_elems: int        # duplicate-value arithmetic element-ops
    redundant_by_region: dict
    total_arith: int
    total_moves: int
    n_tiles: int                # blocks of the kernel's launches
    fp32_floor_ms: float        # total_arith at an H100 SXM's fp32 peak

    def table(self) -> str:
        rows = ["%-48s %12s %8s %10s" % ("term region", "arith elems",
                                         "share", "dup elems")]
        for label, v in sorted(self.region_elems.items(),
                               key=lambda kv: -kv[1]):
            rows.append("%-48s %12d %7.1f%% %10d" % (
                label, v, 100.0 * v / max(self.total_arith, 1),
                self.redundant_by_region.get(label, 0)))
        rows.append("%-48s %12d %8s %10d" % (
            "TOTAL (arith)", self.total_arith, "", self.redundant_elems))
        rows.append("%-48s %12d" % ("data movement (view/copy/cat/roll)",
                                    self.total_moves))
        rows.append("redundancy ceiling: %.2f%% of arithmetic element-ops"
                    % (100.0 * self.redundant_elems
                       / max(self.total_arith, 1)))
        rows.append("fp32 floor of the arithmetic on an H100 SXM: %.4g ms "
                    "a call (%d blocks)" % (self.fp32_floor_ms,
                                            self.n_tiles))
        return "\n".join(rows)


def audit_substep(baseline: int = 3, which: str = "corrector",
                  with_phys: bool = True, device="cuda") -> Audit:
    """Count the plain version of a substep kernel (``which`` =
    'predictor' for the same-base Matsuno predictor, 'corrector' for the
    tendency + update [+ physics epilogue] kernel) at the given baseline's
    shapes, with the radiative source and diffusion on, as the reference
    audits its kernel."""
    from ..core.config import baseline_config
    from ..core.init import initialize
    from ..kernels.fused_substep import fused_substep_plain, launch_plan
    from ..model import phys_epilogue_tuple

    cfg = baseline_config(baseline)
    same_base = which == "predictor"
    phys = phys_epilogue_tuple(cfg) if with_phys and not same_base else None
    state, forcing, grid = initialize(cfg, device=device)
    base = None if same_base else state
    counter = _Counter()
    with counter:
        fused_substep_plain(state, base, grid, forcing, grid.dt,
                            with_rad=True, with_diff=True, phys=phys)
    plan = launch_plan(cfg.grid.nz, cfg.grid.ny, cfg.grid.nx)
    n_tiles = plan.substep.grid[0] * plan.substep.grid[1]
    if phys is not None:
        n_tiles += plan.epilogue.grid[0] * plan.epilogue.grid[1]
    total = sum(counter.arith.values())
    return Audit(region_elems=dict(counter.arith),
                 region_moves=dict(counter.moves),
                 redundant_elems=sum(counter.redundant.values()),
                 redundant_by_region=dict(counter.redundant),
                 total_arith=total, total_moves=sum(counter.moves.values()),
                 n_tiles=n_tiles,
                 fp32_floor_ms=1e3 * total / dict(PEAKS)["H100 80GB HBM3"]
                 .fp32_flops)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    for which, wp, label in (
            ("corrector", True, "corrector + physics epilogue"),
            ("corrector", False, "corrector (dynamics only)"),
            ("predictor", False, "predictor (same-base)")):
        print(f"=== config #{a.baseline} {label} ===")
        print(audit_substep(a.baseline, which=which, with_phys=wp,
                            device=a.device).table())
        print()
