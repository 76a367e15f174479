"""The kernel gates and timings of one checkout: ``chip_smoke.py``'s phases
3 and 4 alone.

Builds the kernels of the checkout at ROOT, holds the variants at config #3
and at #4's shard blocks against their plain versions
(``check_kernels``, ``check_shards``), and times them
(``time_kernels``, ``time_shards``); prints the ptxas lines and one
``TIMING`` and one ``SHARD_TIMING`` JSON line (device ms, each launch's
profiled ms, host enqueue ms). To compare two commits on one card, unpack
the parent's ``climate_model_tpu_torch/`` and ``chip_smoke.py`` into a
directory that ``.gitignore`` lists and run both in one call, in turns:

    python3 tools/kernel_timing.py _archive/parent
    python3 tools/kernel_timing.py .
    python3 tools/kernel_timing.py .
    python3 tools/kernel_timing.py _archive/parent
"""
import json
import os
import sys
import time

root = sys.argv[1] if len(sys.argv) > 1 else "."
sys.path.insert(0, os.path.abspath(root))
os.chdir(root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from climate_model_tpu_torch.kernels import fused_substep as fs  # noqa

T0 = time.perf_counter()
dev = torch.device("cuda", 0)
card = cs.card_line()
print(f"== {root}: {card}; torch {torch.__version__}", flush=True)
info = fs.build(force=True)
for name, lines in cs.ptxas_lines(info.log):
    print(f"  ptxas {name}: " + " | ".join(lines), flush=True)
ci = cs.check_inputs(dev)
cs.check_kernels(ci)
timing = cs.time_kernels(ci, card)
keys = ("ms", "launch_ms", "enqueue_ms")
print("TIMING " + json.dumps({k: {kk: v[kk] for kk in keys}
                              for k, v in timing.items()}), flush=True)
bad = []
_, shard_inputs = cs.check_shards(cs.noisy_state(4, dev), dev, bad)
if bad:
    raise AssertionError("; ".join(bad))
st = cs.time_shards(shard_inputs, card)
print("SHARD_TIMING " + json.dumps({k: {kk: v[kk] for kk in keys}
                                    for k, v in st.items()}), flush=True)
print(f"== done {time.perf_counter() - T0:.1f}s", flush=True)
