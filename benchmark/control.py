"""The control of ``correct``: the plain reference that judges the cell
(``harness.reference_of``) put in the program's place with its state held
one precision below the configuration's (``LOWER``: bfloat16 under
float32, float32 under float64; rounded before the first step and after
every step, the arithmetic staying at the configuration's), held against
the same reference at the configuration's precision by the cell's limits.
It has to come out as not correct. (TF32 would change nothing: the model
has no matrix product. The reference computed wholly in bfloat16 goes
non-finite within its first step and gives no number.)

    python3 benchmark/control.py --workload bl3_run --seeds 21 22 23

From the root of a checkout, on a card (``--device cpu`` at a test's size).
Each seed's stretch is the cell's first chunk from its seeded state: the
same number of steps, at the same size, as the stretch a run compares.
Prints one JSON line a seed with its readings and whether the limits hold.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import check, harness, inputs  # noqa: E402


# the precision below each working precision a configuration may state
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def readings(cell, seed: int, device="cuda") -> dict:
    """The control's reading of each compared field: the largest gap
    between the reference with its state held one precision below the
    configuration's and at the configuration's, after the cell's first
    chunk from the seeded state."""
    ref = harness.reference_of(cell)
    dev = ref.model.reference_device(device)
    rcfg = ref.config.config_from_dict(harness.run_namelist(cell, 1))
    n, _ = harness.chunk_steps(cell)
    arrays = inputs.seeded_state(ref, rcfg, seed)
    s_in = dict(fields={f: torch.as_tensor(arrays[f])
                        for f in ref.model.STATE_FIELDS},
                t=torch.as_tensor(arrays["t"]), step=0)
    out, _ = check.reference_chunk(ref, rcfg, s_in, n, dev)
    out_low, _ = check.reference_chunk(ref, rcfg, s_in, n, dev,
                                       store=LOWER[rcfg.dtype])
    return {f: check.max_gap(getattr(out_low, f), getattr(out, f))
            for f in check.COMPARED}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, args.device)
        ok, _ = check.judge(r, {f: cell.limits[f] for f in check.COMPARED
                                  if f in cell.limits})
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              readings=r, correct=ok,
                              seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
