"""Where the time of the substep and physics-epilogue kernels goes, by
phase: each kernel is built again with an early return before one of its
phases, and the device time of each launch at config #3 is read for every
cut, beside the whole kernel's.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/kernel_phases.py

The cuts are made on copies of ``climate_model_tpu_torch/kernels/csrc/`` in
the git-ignored build directory, at the phase comments of the sources
(``CUTS``); the script fails if a comment is gone. A cut kernel computes
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

# (name, file, the phase comment to return before)
CUTS = (
    ("substep: staging only", "fused_substep.cu",
     "  // the surface border's Exner factor of each column"),
    ("substep: staging and scans", "fused_substep.cu",
     "  // 3. the update, one thread per point"),
    ("epilogue: staging only", "physics_epilogue.cu",
     "  // 2. the surface core, then the profile"),
    ("epilogue: up to the profiles", "physics_epilogue.cu",
     "  // 3. the physics, one warp per column"),
    ("epilogue: all but the stores", "physics_epilogue.cu",
     "  // 4. store the tile's five fields"),
)


def build_cut(name: str, path: str, marker: str | None):
    """The kernel library with ``return`` inserted before ``marker`` in
    ``path`` (None: unchanged), loaded."""
    out = os.path.join(fs.BUILD_DIR, "phases", name.replace(" ", "_")
                       .replace(":", ""))
    os.makedirs(out, exist_ok=True)
    sources = []
    for f in sorted(os.listdir(fs.CSRC)):
        text = open(os.path.join(fs.CSRC, f)).read()
        if f == path:
            if marker not in text:
                raise RuntimeError(f"{f}: the phase comment {marker!r} is gone")
            text = text.replace(marker, "  if (nz > 0) return;\n" + marker, 1)
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
    for name, path, marker in (("whole kernels", "", None), *CUTS):
        fs._loaded["lib"] = build_cut(name, path, marker)
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
