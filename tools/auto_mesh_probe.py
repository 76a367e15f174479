"""The plain backend's mesh paths across four cards, by mesh shape.

Runs what ``chip_smoke.py --multicard`` (phase 16) runs of the plain
backend, on more meshes and without the rest of the phase: BASELINE #4 on
``backend='jnp'`` over phase 12's 20 steps, ``shard_map`` on 2x2 and GSPMD
``auto`` (DTensors) on 2x2, 1x4 and 4x1, one rank a card under NCCL, each
held against the same grid unsharded on card 0 (bit for bit, or within
``MC_AUTO_TOL``: a reading either way); and phase 16's planted faults of
the plain path from the noisy #4 state. Before the ranks start, card 0
holds the kernel variants at phase 16's blocks against their plain
versions and times them (``mc_kernels``).

Run from the root of a checkout on a machine with four NVIDIA cards:

    python3 tools/auto_mesh_probe.py

It starts its ranks itself (``torchrun --standalone --nproc-per-node 4``
of this file with ``--worker DIR``). The last line lists what broke a
bound (a list of gate failures, empty when none did).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RUNS = (("jnp_2x2_shard_map", dict(cs.MC_RUNS)["jnp_2x2_shard_map"]),
        ("jnp_2x2_auto", dict(cs.MC_RUNS)["jnp_2x2_auto"]),
        ("jnp_1x4_auto", cs.on_mesh(cs.JNP_AUTO_ARGV, 1, 4)),
        ("jnp_4x1_auto", cs.on_mesh(cs.JNP_AUTO_ARGV, 4, 1)))


def worker(root: str) -> int:
    """One rank: the runs of RUNS, then the plain path's faults."""
    from climate_model_tpu_torch import cli
    cs.MC_RUNS = RUNS
    cs.MC_FAULTS = ()
    with cli.multihost("cuda") as dev:
        rank = torch.distributed.get_rank()
        rec = {name: cs.worker_run(argv, dev, root, name)
               for name, argv in RUNS}
        cs.worker_faults(cs.load_noisy(root, dev), dev, root)
        with open(f"{root}/rank{rank}.json", "w") as f:
            json.dump(rec, f)
    return 0


def main() -> int:
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, torch.__version__, flush=True)
    info = cs.fs.build(force=True)
    print(f"build {info.seconds:.2f} s", flush=True)
    root = tempfile.mkdtemp(prefix="auto_mesh_probe_")
    try:
        return probe(root, dev, card, t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def probe(root: str, dev, card: str, t0: float) -> int:
    """The kernel checks, the ranks' runs and their readings, in ``root``."""
    noisy = cs.noisy_state(4, dev)
    np.savez(os.path.join(root, "noisy.npz"), **cs.state_to_numpy(noisy[1]))
    bad = []
    kern = cs.mc_kernels(noisy, dev, card, bad)
    for k, (errs, tm) in kern.items():
        for name, t in tm.items():
            tol = cs.SHARD_EPI_TOL if name.startswith("corrector") \
                else cs.SHARD_TOL
            print("KERNEL", k, name, json.dumps(
                {x: t[x] for x in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")}),
                  "err/tol", max(e / tol[f] for f, e in errs[name].items()),
                  flush=True)
    print("kernel bad:", bad, time.perf_counter() - t0, flush=True)
    ok = cs.torchrun([os.path.abspath(__file__), "--worker", root], 400,
                     os.path.join(root, "worker.log"))
    print("worker ok", ok, time.perf_counter() - t0, flush=True)
    ranks = []
    for r in range(cs.MC_WORLD):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    cs.MC_RUNS = RUNS
    cs.MC_FAULTS = ()
    cs.mc_runs(ranks, cs.References(dev, card), root, card, bad)
    cs.mc_faults(noisy, root, bad)
    print("BAD:", bad, time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2]))
    sys.exit(main())
