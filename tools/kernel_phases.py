"""Where the time of the substep and physics-epilogue kernels goes, by
kind of task: each kernel is built again with an early return at the start
of the work of one or more of its kinds of task, and the device time of
each launch at configs #3 and #5 is read for every cut, beside the whole
kernels'.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/kernel_phases.py [ROOT]

ROOT (default: this checkout) names the checkout whose kernels are cut, say
another commit's ``climate_model_tpu_torch/`` unpacked into a directory
that ``.gitignore`` lists; its wrappers launch its kernels
(``chip_smoke.py::reference_kernels``). The cuts are made on copies of its
``kernels/csrc/`` in the git-ignored build directory, at the comments that
open each kind of task's work (``CUTS``); the script fails if a comment is
gone. A cut task returns at once and still counts as done, so the tasks
after it run on whatever its slots hold: a cut kernel computes garbage, and
only its time is read. Times are device ms per call of each launch of the
masked predictor (the substep) and of the corrector with the physics
epilogue (the substep, then the epilogue), each launch apart
(``bench/micro.py::launch_ms``: profiled), the median of ``ROUNDS`` rounds
that time every build in turn (timed one build after the other, the
unchanged substep drifted by a quarter over the sequence).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from climate_model_tpu_torch.core.config import baseline_config  # noqa: E402
from climate_model_tpu_torch.kernels import fused_substep as fs  # noqa: E402

# the comments that open the work of each kind of task
UPDATE = "  // the update of a pass of levels"
TERMS = "  // the terms of a column"
SUMS = "  // the sums of the columns"
SURFACE = "  // the surface cores of a row"
PROFILE = "  // the profile of a column"
PHYSICS = "  // the physics of a column"
STORES = "  // the stores of a row"
# (name, file, the comments to return before, the return)
SUBSTEP_RETURN = "  if (a.nz > 0) return;\n"
EPILOGUE_RETURN = "  if (e.nz > 0) return;\n"
ROUNDS = 3
CUTS = (
    ("substep: copies and scans, no update", "fused_substep.cu", (UPDATE,),
     SUBSTEP_RETURN),
    ("substep: copies and update, no scans", "fused_substep.cu",
     (TERMS, SUMS), SUBSTEP_RETURN),
    ("substep: copies only", "fused_substep.cu", (UPDATE, TERMS, SUMS),
     SUBSTEP_RETURN),
    ("epilogue: copies only", "physics_epilogue.cu",
     (SURFACE, PROFILE, PHYSICS, STORES), EPILOGUE_RETURN),
    ("epilogue: copies, surface cores and profiles", "physics_epilogue.cu",
     (PHYSICS, STORES), EPILOGUE_RETURN),
    ("epilogue: all but the physics", "physics_epilogue.cu", (PHYSICS,),
     EPILOGUE_RETURN),
    ("epilogue: all but the stores", "physics_epilogue.cu", (STORES,),
     EPILOGUE_RETURN),
)


def build_cut(mod, name: str, path: str, markers: tuple, ret: str):
    """The kernel library of the wrappers ``mod`` with ``ret`` inserted
    before each of ``markers`` in ``path`` (no markers: unchanged),
    loaded."""
    out = os.path.join(mod.BUILD_DIR, "phases", name.replace(" ", "_")
                       .replace(":", "").replace(",", ""))
    os.makedirs(out, exist_ok=True)
    sources = []
    for f in sorted(os.listdir(mod.CSRC)):
        text = open(os.path.join(mod.CSRC, f)).read()
        if f == path:
            for marker in markers:
                if text.count(marker) != 1:
                    raise RuntimeError(f"{f}: the comment {marker!r} is "
                                       "gone")
                text = text.replace(marker, ret + marker, 1)
        with open(os.path.join(out, f), "w") as fh:
            fh.write(text)
        if f.endswith(".cu"):
            sources.append(os.path.join(out, f))
    lib_path = os.path.join(out, "lib.so")
    proc = subprocess.run([mod._nvcc(), *mod.NVCC_FLAGS, "-o", lib_path,
                           *sources], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for fn_name, argtypes in mod._ARGTYPES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def timed_calls(mod, ci):
    """The masked predictor and the corrector with the physics epilogue of
    the wrappers ``mod`` on the inputs ``ci`` (``chip_smoke.py::
    check_inputs``)."""
    g, f, dt, vm = ci.grid, ci.forcing, ci.grid.dt, ci.vmask
    ev, base = cs.epilogue_args(ci)[:2]
    return (lambda: mod.predictor(ci.state, g, f, dt, vmask=vm, **ci.kw),
            lambda: mod.corrector(ev, base, g, f, dt, phys=ci.phys,
                                  vmask=vm, **ci.kw))


def main(root: str | None = None, cuts=CUTS) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA card")
    mod = fs if root is None else cs.reference_kernels(root)
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    calls = [(b, *timed_calls(mod, cs.check_inputs(dev, baseline_config(b))))
             for b in (3, 5)]
    builds = [(name, build_cut(mod, name, path, markers, ret))
              for name, path, markers, ret in (("whole kernels", "", (), ""),
                                               *cuts)]
    times = {}
    for _ in range(ROUNDS):
        for name, lib in builds:
            mod._loaded["lib"] = lib
            for baseline, pred, corr in calls:
                for what, fn in (("predictor", pred),
                                 ("corrector+epilogue", corr)):
                    for launch, ms in cs.profiled_ms(fn).items():
                        times.setdefault((name, baseline, what, launch),
                                         []).append(ms)
    for name, _ in builds:
        for baseline, _, _ in calls:
            parts = []
            for what in ("predictor", "corrector+epilogue"):
                split = {launch: sorted(t)[len(t) // 2] for (n, b, w, launch),
                         t in times.items()
                         if (n, b, w) == (name, baseline, what)}
                parts.append(f"{what} " + ", ".join(
                    f"{k} {v:.4f}" for k, v in split.items()))
            print(f"{name}: " + "; ".join(parts) + f" (device ms per call, "
                  f"median of {ROUNDS}, config #{baseline}; "
                  f"{root or 'this checkout'}) [{card}]", flush=True)
    mod._loaded.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1] if len(sys.argv) > 1 else None))
