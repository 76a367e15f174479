"""Whether a CUDA graph can capture the point-to-point posts of a ghost
exchange across cards, under NCCL.

Four ranks, one card each, on a 2x2 mesh laid out as the sharded packed
scan lays it out (``dist/comm.py``): each rank sends a packed buffer east
and west (one lon partner on a 2-wide ring, two tags, posted in
``DistExchange.LON_SENDS`` order) and one to its lat partner, with
``batch_isend_irecv``. Each rank warms every peer pair eagerly, then
captures the pack copies, the posts, the waits and the unpack copies in one
``torch.cuda.CUDAGraph`` and replays it with new data each time, checking
every received slab. It times the eager exchange and the replay in turns
(host ms to enqueue, and ms to the end on the card).

Run from the root of a checkout on a machine with four NVIDIA cards:

    python3 tools/nccl_capture_probe.py [--mode global|thread_local|relaxed]

It starts its ranks itself (``torch.multiprocessing``, ``tcp://localhost``)
and kills them after ``TIMEOUT_S``. Each rank prints one JSON line; the last
line says whether every rank captured and replayed the exchange right and
then left the process group (``destroy_process_group`` after the graph is
freed: with the graph alive, the first run of this probe on four H100s
with PyTorch 2.11 and NCCL 2.28.9 waited there until it was killed).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import tempfile
import time

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT_S = 120
FIELDS, NZ, NY, NX, G = 12, 32, 363, 726, 3     # #5's 2x2 block, 3 ghosts
REPLAYS, TIMED = 10, 50


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_version() -> str:
    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


def rank_main(rank: int, port: int, mode: str, out: str):
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                             world_size=WORLD, rank=rank)
    a, b = divmod(rank, 2)
    lon, lat = a * 2 + (1 - b), (1 - a) * 2 + b
    # (peer, tag) of each send, in posting order, and of each receive
    sends = [(lon, 0), (lon, 1), (lat, 2 + a)]
    recvs = [(lon, 0), (lon, 1), (lat, 3 - a)]
    n = FIELDS * NZ * NY * G                       # a column slab's floats
    src = torch.empty(FIELDS, NZ, NY, 4 * G, device=dev)
    dst = torch.zeros(FIELDS, NZ, NY, 3 * G, device=dev)
    send = [torch.empty(n, device=dev) for _ in sends]
    recv = [torch.empty(n, device=dev) for _ in recvs]
    rec = {"rank": rank, "mode": mode, "torch": torch.__version__,
           "nccl": nccl_version(),
           "card": torch.cuda.get_device_name(dev)}

    def exchange():
        for i, buf in enumerate(send):
            buf.view(FIELDS, NZ, NY, G).copy_(src[..., i * G:(i + 1) * G])
        ops = [tdist.P2POp(tdist.isend, buf, p, tag=t)
               for buf, (p, t) in zip(send, sends)]
        ops += [tdist.P2POp(tdist.irecv, buf, p, tag=t)
                for buf, (p, t) in zip(recv, recvs)]
        for r in tdist.batch_isend_irecv(ops):
            r.wait()
        for i, buf in enumerate(recv):
            dst[..., i * G:(i + 1) * G].copy_(buf.view(FIELDS, NZ, NY, G))

    def fill(k: int):
        src.copy_(torch.arange(src.numel(), device=dev,
                               dtype=torch.float32).view(src.shape) % 977
                  + 1000.0 * (k * WORLD + rank))

    def check(k: int) -> bool:
        # what each peer sent with the same k: its slab i is its columns
        # [i*G, (i+1)*G); the receive from a peer with tag t is its send i
        # with the same tag
        base = torch.arange(src.numel(), device=dev,
                            dtype=torch.float32).view(src.shape) % 977
        ok = True
        for i, (p, t) in enumerate(recvs):
            j = [q for q, (pp, tt) in enumerate(
                [(lon, 0), (lon, 1), (lat, 2 + (1 - a))]) if tt == t][0]
            want = base[..., j * G:(j + 1) * G] + 1000.0 * (k * WORLD + p)
            ok &= bool(torch.equal(dst[..., i * G:(i + 1) * G], want))
        return ok

    try:
        for k in range(3):                      # warm every peer pair
            fill(k)
            exchange()
        torch.cuda.synchronize(dev)
        rec["eager_ok"] = check(2)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            exchange()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode=mode):
            exchange()
        rec["capture_s"] = time.perf_counter() - t0
        oks = []
        for k in range(10, 10 + REPLAYS):
            fill(k)
            graph.replay()
            torch.cuda.synchronize(dev)
            oks.append(check(k))
        rec["replays_ok"] = all(oks)
        rec["replays"] = len(oks)
        for name, fn in (("eager", exchange), ("graph", graph.replay),
                         ("graph2", graph.replay), ("eager2", exchange)):
            tdist.barrier(device_ids=[rank])
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(TIMED):
                fn()
            host = time.perf_counter() - t0
            torch.cuda.synchronize(dev)
            rec[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / TIMED
            rec[f"{name}_host_ms"] = host * 1e3 / TIMED
        # the group's teardown waits for a live graph's NCCL work: the
        # graph goes first
        del graph
        torch.cuda.synchronize(dev)
    except Exception as exc:                    # a reading, not a crash
        rec["error"] = f"{type(exc).__name__}: {exc}"[:800]
    path = os.path.join(out, f"rank{rank}.json")
    with open(path, "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec), flush=True)
    if "error" not in rec:
        t0 = time.perf_counter()
        tdist.destroy_process_group()
        rec["destroy_s"] = time.perf_counter() - t0
        with open(path, "w") as f:
            json.dump(rec, f)
    os._exit(0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="global",
                    choices=("global", "thread_local", "relaxed"))
    ap.add_argument("--out", default=None,
                    help="where the ranks write their records (default: a "
                         "temporary directory, removed at the end)")
    args = ap.parse_args()
    if torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards, found {torch.cuda.device_count()}")
        return 1
    if args.out is None:
        tmp = tempfile.mkdtemp(prefix="nccl_capture_probe_")
        try:
            return probe(args.mode, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(args.out, exist_ok=True)
    return probe(args.mode, args.out)


def probe(mode: str, out: str) -> int:
    """The ranks, started, joined and read back; 0 when every rank
    captured and replayed the exchange right and left the group."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, mode, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    t_end = time.time() + TIMEOUT_S
    for p in procs:
        p.join(max(1.0, t_end - time.time()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    recs = []
    for r in range(WORLD):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                recs.append(json.load(f))
    ok = (len(recs) == WORLD and not hung
          and all(r.get("replays_ok") and r.get("eager_ok") for r in recs))
    print(json.dumps({"mode": mode, "captured": ok, "hung": hung,
                      "ranks_reported": len(recs)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
