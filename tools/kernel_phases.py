"""Where the time of the substep and physics-epilogue kernels goes, by
phase: each kernel is built again with an early return at the start of one
or more of its phases, and the device time of each launch at config #3 is
read for every cut, beside the whole kernel's.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/kernel_phases.py

The cuts are made on copies of ``climate_model_tpu_torch/kernels/csrc/`` in
the git-ignored build directory, at the phase comments of the sources
(``CUTS``); the script fails if a comment is gone. The substep's phases are
its kinds of task: a cut task returns at once and still counts as done, so
the tasks after it run on whatever its slots hold. A cut kernel computes
garbage: only its time is read. Times are device ms per call of the masked
predictor (the substep launch) and of the corrector with the physics
epilogue (``bench/micro.py::launch_ms``: each launch apart, profiled).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from climate_model_tpu_torch.bench.micro import launch_ms  # noqa: E402
from climate_model_tpu_torch.kernels import fused_substep as fs  # noqa: E402

# the substep's phase comments, at the start of its kinds of task
UPDATE = "  // the update of a pass of levels"
TERMS = "  // the terms of a column"
SUMS = "  // the sums of the columns"
# (name, file, the phase comments to return before, the return)
SUBSTEP_RETURN = "  if (a.nz > 0) return;\n"
EPILOGUE_RETURN = "  if (nz > 0) return;\n"
CUTS = (
    ("substep: copies and scans, no update", "fused_substep.cu", (UPDATE,),
     SUBSTEP_RETURN),
    ("substep: copies and update, no scans", "fused_substep.cu",
     (TERMS, SUMS), SUBSTEP_RETURN),
    ("substep: copies only", "fused_substep.cu", (UPDATE, TERMS, SUMS),
     SUBSTEP_RETURN),
    ("epilogue: staging only", "physics_epilogue.cu",
     ("  // 2. the surface core, then the profile",), EPILOGUE_RETURN),
    ("epilogue: up to the profiles", "physics_epilogue.cu",
     ("  // 3. the physics, one warp per column",), EPILOGUE_RETURN),
    ("epilogue: all but the stores", "physics_epilogue.cu",
     ("  // 4. store the tile's five fields",), EPILOGUE_RETURN),
)


def build_cut(name: str, path: str, markers: tuple, ret: str):
    """The kernel library with ``ret`` inserted before each of ``markers``
    in ``path`` (no markers: unchanged), loaded."""
    out = os.path.join(fs.BUILD_DIR, "phases", name.replace(" ", "_")
                       .replace(":", "").replace(",", ""))
    os.makedirs(out, exist_ok=True)
    sources = []
    for f in sorted(os.listdir(fs.CSRC)):
        text = open(os.path.join(fs.CSRC, f)).read()
        if f == path:
            for marker in markers:
                if text.count(marker) != 1:
                    raise RuntimeError(f"{f}: the phase comment {marker!r} "
                                       "is gone")
                text = text.replace(marker, ret + marker, 1)
        with open(os.path.join(out, f), "w") as fh:
            fh.write(text)
        if f.endswith(".cu"):
            sources.append(os.path.join(out, f))
    lib_path = os.path.join(out, "lib.so")
    proc = subprocess.run([fs._nvcc(), *fs.NVCC_FLAGS, "-o", lib_path,
                           *sources], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for fn_name, argtypes in fs._ARGTYPES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    ci = cs.check_inputs(dev)
    g, f, dt, st, kw, vm = (ci.grid, ci.forcing, ci.grid.dt, ci.state,
                            ci.kw, ci.vmask)
    ev, base = cs.epilogue_args(ci)[:2]
    for name, path, markers, ret in (("whole kernels", "", (), ""), *CUTS):
        fs._loaded["lib"] = build_cut(name, path, markers, ret)
        pred = launch_ms(lambda: fs.predictor(st, g, f, dt, vmask=vm,
                                              **kw))
        corr = launch_ms(lambda: fs.corrector(ev, base, g, f, dt,
                                              phys=ci.phys, vmask=vm, **kw))
        print(f"{name}: predictor {pred}; corrector+epilogue {corr} "
              f"(device ms per call, config #3) [{card}]", flush=True)
    fs._loaded.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
