"""The body of one gloo rank of the four-card cell at a test's size: the
harness's run on the CPU, with the ghost exchange left out if asked; rank
0 writes its result to ``out``."""

import json
import os


def rank_main(rank: int, port: int, fault: str, out: str):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank))
    import torch
    torch.set_num_threads(1)
    if fault == "no_exchange":
        from climate_model_tpu_torch.dist import comm

        class Nothing:
            def wait(self):
                return None

        comm.DistExchange._exchange = lambda self, sends, recvs: Nothing()
    from benchmark.tests._small import run_small
    res = run_small("bl5_2x2_overlap", seed=4_000_000_021)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(dict(correct=res["correct"],
                           readings=res["readings"]), f)
