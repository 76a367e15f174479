"""The substep and physics-epilogue kernels of this checkout against
another checkout's, bit for bit, on every block the port launches them on,
and timed in turns.

Run from the root of a checkout on a machine with one NVIDIA card, with
the other checkout's ``climate_model_tpu_torch/`` unpacked into a
directory that ``.gitignore`` lists (the parent commit's, say):

    git archive PARENT climate_model_tpu_torch | tar -x -C _archive/parent
    python3 tools/kernel_bitwise.py _archive/parent

Builds both kernel libraries (each from its own ``csrc/`` into its own
build directory) and runs ``chip_smoke.py::check_against`` over
``AGAINST_CASES``: every substep variant, the corrector with the physics
epilogue and the epilogue alone on the same inputs, equal bit for bit in
every field they write, and the device ms a launch of ``AGAINST_TIMED``
(the masked predictor's and corrector's substep, the epilogue) in turns
(other, this, this, other) beside this checkout's plan counts. Prints one
line a case and one ``AGAINST`` JSON line; exits non-zero if any field
differs.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from climate_model_tpu_torch.kernels import fused_substep as fs  # noqa: E402


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"== this checkout against {sys.argv[1]}: {card}; torch "
          f"{torch.__version__}", flush=True)
    ref = cs.reference_kernels(sys.argv[1])
    for name, mod in (("this", fs), ("other", ref)):
        info = mod.build(force=True)
        for kname, lines in cs.ptxas_lines(info.log):
            print(f"  ptxas {name} {kname}: " + " | ".join(lines), flush=True)
    out = cs.check_against(ref, dev, card)
    print("AGAINST " + json.dumps(out), flush=True)
    print(f"== done {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
