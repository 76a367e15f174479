"""The paths across ranks on the CPU, beside ``chip_smoke.py``'s phase 16.

* A tag-blind transport: an in-process stand-in for ``batch_isend_irecv``
  that ignores tags and matches the messages of a pair of ranks in the
  order they were posted, as NCCL does (gloo honours tags, so the spawned
  gloo ranks cannot show an order fault). ``DistExchange.refresh`` and
  ``DistEdges.swap`` on 2x2, 1x4 and 4x1 meshes, one thread a rank, must
  equal ``LocalExchange`` / ``LocalEdges`` bit for bit; with the column
  sends posted west first, the 2x2 mesh (both lon neighbours one rank)
  must not, and the other two are unchanged.
* 4 gloo ranks, spawned once for the module: the sharded packed scan on
  1x4 (blocking) and 4x1 (halo overlap) through ``cli.run`` after
  ``cli.init_multihost``, equal to the same run in one process bit for bit,
  each run's checkpoint set read back with phase 16's ``read_set``; and
  ``bench --scaling --multihost`` on a 2x2 namelist, one JSON line from
  rank 0 and none from the others.
* Phase 16's pure helpers: its case list and the unsharded runs each case
  is held against, the 2x2 namelists, the launch counts of a mesh run, and
  a checkpoint set that misses a file or mixes two saves, refused.

The config is ``test_torch_dist_mp.py``'s with 24 rows, so that a 4x1
mesh's 6 rows a shard take the overlap schedule. The ranks are spawned at
the lowest priority with one thread each and joined within ``TIMEOUT_S``,
as the other ``_mp`` modules do.
"""

import collections
import dataclasses
import json
import multiprocessing as mp
import os
import shutil
import socket
import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from climate_model_tpu_torch import cli
from climate_model_tpu_torch.core.config import baseline_config
from climate_model_tpu_torch.core.namelist import load_config
from climate_model_tpu_torch.dist import comm, sharding
from climate_model_tpu_torch.dist.mesh import Mesh
from climate_model_tpu_torch.io.checkpoint import load_checkpoint

from ._torch_multicard_ranks import (NAMELIST, RUNS, TIMEOUT_S, WORLD,
                                     auto_cfg, mc_cfg, rank_main)
from ._torch_threads import torch_threads  # noqa: F401 (fixture)

MESHES = ((2, 2), (1, 4), (4, 1))


# ---------------------------------------------------------------------------
# A tag-blind transport
# ---------------------------------------------------------------------------

class TagBlind:
    """``torch.distributed``'s point-to-point calls as NCCL matches them,
    between threads of this process (``local.rank``: the thread's rank).
    Tags are ignored: the k-th receive that a rank posts from a peer takes
    the k-th message that the peer posted to it, whatever its tag. An
    empty list of operations raises, as ``batch_isend_irecv`` does."""

    isend, irecv = "isend", "irecv"

    def __init__(self):
        self.local = threading.local()
        self.cond = threading.Condition()
        self.sent = collections.defaultdict(list)   # (src, dst): messages
        self.posted = collections.Counter()         # (src, dst): receives

    def P2POp(self, op, tensor, peer, tag=0):
        return types.SimpleNamespace(op=op, tensor=tensor, peer=peer,
                                     tag=tag)

    def batch_isend_irecv(self, ops):
        ops[0]                      # torch reads the first op's group
        me, works = self.local.rank, []
        with self.cond:
            for op in ops:
                if op.op == self.isend:
                    self.sent[(me, op.peer)].append(op.tensor.clone())
                else:
                    key = (op.peer, me)
                    works.append(_Recv(self, key, self.posted[key],
                                       op.tensor))
                    self.posted[key] += 1
            self.cond.notify_all()
        return works


class _Recv:
    def __init__(self, net, key, k, into):
        self.net, self.key, self.k, self.into = net, key, k, into

    def wait(self):
        net = self.net
        with net.cond:
            if not net.cond.wait_for(
                    lambda: len(net.sent[self.key]) > self.k, timeout=20):
                raise TimeoutError(f"receive {self.k} of {self.key} never "
                                   "came")
            msg = net.sent[self.key][self.k]
        if msg.numel() != self.into.numel():
            raise RuntimeError(f"message of {msg.numel()} elements into a "
                               f"buffer of {self.into.numel()}")
        self.into.copy_(msg.view(self.into.shape))
        return True


def on_ranks(n: int, fn, net=None) -> list:
    """``fn(rank)`` on ``n`` threads (``net.local.rank`` set in each); the
    results in rank order; the first failure re-raised."""
    out, errs = [None] * n, []

    def work(r):
        if net is not None:
            net.local.rank = r
        try:
            out[r] = fn(r)
        except BaseException as e:        # noqa: BLE001 (re-raised below)
            errs.append(e)

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a rank thread hung"
    if errs:
        raise errs[0]
    return out


def garbled_blocks(shape, seed=0):
    """The layouts of every shard of ``shape`` and, per shard, a 3-D and a
    2-D block whose interiors are cut from random global fields and whose
    ghosts are noise; and the blocks cut with their true ghosts."""
    n_lat, n_lon = shape
    g = torch.Generator().manual_seed(seed)
    ny, nx = 24, 24
    glob = [torch.randn(2, ny, nx, generator=g, dtype=torch.float64),
            torch.randn(ny, nx, generator=g, dtype=torch.float64)]
    mesh = Mesh(n_lat, n_lon, torch.device("cpu"))
    lays = [sharding.layout(mesh, s, ny, nx) for s in range(mesh.size)]
    true = [[sharding.split(x, lay) for x in glob] for lay in lays]
    blocks = []
    for lay, bs in zip(lays, true):
        noisy = []
        for b in bs:
            x = torch.randn(b.shape, generator=g, dtype=b.dtype)
            sharding.interior(x, lay).copy_(sharding.interior(b, lay))
            noisy.append(x)
        blocks.append(noisy)
    return mesh, lays, blocks, true


def dist_refresh(shape, monkeypatch) -> tuple:
    """``DistExchange.refresh`` over the tag-blind transport, one thread a
    rank; returns (every rank's blocks, LocalExchange's, the true ones)."""
    mesh, lays, blocks, true = garbled_blocks(shape)
    local = [[x.clone() for x in bs] for bs in blocks]
    comm.LocalExchange(mesh, lays).refresh(local)
    net = TagBlind()
    monkeypatch.setattr(comm, "tdist", net)

    def rank(r):
        ex = comm.DistExchange(dataclasses.replace(mesh, rank=r), lays)
        mine = [x.clone() for x in blocks[r]]
        ex.refresh([mine])
        return mine

    return on_ranks(mesh.size, rank, net), local, true


def same_blocks(a, b) -> bool:
    return all(torch.equal(x, y) for xs, ys in zip(a, b)
               for x, y in zip(xs, ys))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tag_blind_exchange(shape, monkeypatch):
    got, local, true = dist_refresh(shape, monkeypatch)
    assert same_blocks(local, true)
    assert same_blocks(got, local)


@pytest.mark.parametrize("shape,breaks", [((2, 2), True), ((1, 4), False),
                                          ((4, 1), False)],
                         ids=["2x2", "1x4", "4x1"])
def test_tag_blind_swapped_sends(shape, breaks, monkeypatch):
    """The column sends posted west first: on a 2-wide ring each seam gets
    the other side's columns; with distinct neighbours (1x4), or no column
    exchange (4x1), the order does not matter."""
    monkeypatch.setattr(comm.DistExchange, "LON_SENDS", ("west", "east"))
    got, local, _ = dist_refresh(shape, monkeypatch)
    assert same_blocks(got, local) != breaks


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tag_blind_edges(shape, monkeypatch):
    """``DistEdges.swap`` for a shift to each side, every rank in the same
    order, against ``LocalEdges`` (None past a chain end)."""
    mesh = Mesh(*shape, torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    sides = ("west", "east", "south", "north", "west")
    slabs = [[torch.randn(2, 3, 5, generator=g, dtype=torch.float64)
              for _ in sides] for _ in range(mesh.size)]

    def shifts(edges):
        def rank(r):
            return [edges(r).swap(r, ("shift", (2, 3, 5)), side, slab)
                    for side, slab in zip(sides, slabs[r])]
        return rank

    local = comm.LocalEdges(mesh, timeout=20)
    want = on_ranks(mesh.size, shifts(lambda r: local))
    net = TagBlind()
    monkeypatch.setattr(comm, "tdist", net)
    got = on_ranks(mesh.size, shifts(lambda r: comm.DistEdges(
        dataclasses.replace(mesh, rank=r))), net)
    for gr, wr in zip(got, want):
        for x, y in zip(gr, wr):
            assert (x is None) == (y is None)
            assert x is None or torch.equal(x, y)


# ---------------------------------------------------------------------------
# The lat exchange after the predictor, under halo overlap
# ---------------------------------------------------------------------------

class GhostProbe:
    """An exchange that, at each lat exchange of the predicted fields (a
    step's second under halo overlap), records max|exchanged - as before|
    of each field at each ghost row, by its side and depth (1: next to the
    interior)."""

    def __init__(self, inner, names):
        self.inner, self.names, self.n, self.diff = inner, names, 0, {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def refresh_cols(self, fields):
        self.inner.refresh_cols(fields)

    def start_lat(self, fields):
        self.n += 1
        pending = self.inner.start_lat(fields)
        if self.n % 2:
            return pending
        before = [[x.clone() for x in xs] for xs in fields]
        probe = self

        class Wait:
            def wait(self):
                pending.wait()
                probe.record(fields, before)

        return Wait()

    def record(self, fields, before):
        for lay, xs, olds in zip(self.inner.layouts, fields, before):
            rows = [("south", lay.gs - r, r) for r in range(lay.gs)] + [
                ("north", r - lay.gs - lay.ny_l + 1, r)
                for r in range(lay.gs + lay.ny_l, lay.ny_b)]
            for side, depth, r in rows:
                for f, x, old in zip(self.names, xs, olds):
                    d = float((x[..., r, :] - old[..., r, :]).abs().max())
                    key = (side, depth, f)
                    self.diff[key] = max(self.diff.get(key, 0.0), d)


@pytest.mark.parametrize("shape", ((2, 2), (4, 1)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ghost_rows_after_the_predictor(shape):
    """The predictor's seam strips also write the ghost rows, from the
    freshly exchanged rows of the time-n fields; so the lat exchange of the
    predicted fields changes the inner ghost row in no bit, the second
    only in v at a south seam (the strip's own edge row reaches it), and
    the outermost wholly. What the corrector's kept rows read of them
    moves the run by rounding only when that exchange is left out (phase
    16 of chip_smoke.py reads it on the card); leaving out every lat
    exchange does not."""
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist.mesh import make_mesh
    from climate_model_tpu_torch.dist.packed_halo import DYN_FIELDS
    from climate_model_tpu_torch.model import make_chunk_runner

    cfg = mc_cfg(shape, True)
    s, f, g = initialize(cfg, device="cpu")
    ss = sharding.shard(make_mesh(cfg, device="cpu"), s, g, f)
    probe = GhostProbe(ss.exchange, DYN_FIELDS)
    make_chunk_runner(cfg, 3)(ss.replace(exchange=probe), g, f)
    moved = {k for k, d in probe.diff.items() if d}
    assert {k for k in moved if k[1] < 3} == {("south", 2, "v")}
    assert {k[:2] for k in moved if k[1] == 3} == {("south", 3),
                                                    ("north", 3)}
    noisy = (cfg, s, f, g)
    sound = cs.sharded_steps(cfg, noisy, 5, "cpu")
    after = cs.sharded_steps(cfg, noisy, 5, "cpu",
                             leave_out="lat exchange after the predictor")
    none = cs.sharded_steps(cfg, noisy, 5, "cpu", leave_out="lat exchange")
    rounding = cs.state_diffs(sound, after)
    assert 0 < rounding["v"] < 1e-11 and rounding["colp"] < 1e-10
    assert cs.state_diffs(sound, none)["v"] > 1e-5


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory the ranks wrote to, once they all exited 0."""
    out = tmp_path_factory.mktemp("cards")
    (out / "mesh.toml").write_text(NAMELIST)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} ranks still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return out


@pytest.mark.parametrize("name,mesh,overlap", RUNS, ids=[r[0] for r in RUNS])
def test_gloo_ranks_match_in_process(ranks, name, mesh, overlap):
    """Every rank's gathered state, and the run's checkpoint set read back
    in one process, equal the same mesh in one process bit for bit."""
    cfg = mc_cfg(mesh, overlap)
    want = cli.run(cfg, device="cpu")
    assert len(want.chunks) >= 2
    for r in range(WORLD):
        got = torch.load(ranks / f"{name}.rank{r}.pt")
        assert f"1 shard per rank, {WORLD} ranks (gloo)" in got["path"]
        assert ("halo overlap" in got["path"]) == (overlap and mesh[0] > 1)
        assert got["dts"] == want.dts and got["chunks"] == want.chunks
        assert got["step"] == want.state.step
        for f, x in got["state"].items():
            assert torch.equal(x, getattr(want.state, f)), f
    same, per = cs.read_set(str(ranks / name / "restart.npz"), cfg,
                            want.state, "cpu")
    assert same, per
    assert sorted(os.listdir(ranks / name)) == ["metrics.jsonl"] + [
        f"restart.npz.p{r}" for r in range(WORLD)]


def test_gloo_bench_scaling_multihost(ranks):
    """One JSON line, from rank 0 alone, naming the ranks and gloo."""
    outs = [(ranks / f"bench.rank{r}.txt").read_text().splitlines()
            for r in range(WORLD)]
    assert [o[0] for o in outs] == ["0"] * WORLD
    assert all(len(o) == 1 for o in outs[1:])
    (line,) = outs[0][1:]
    rec = json.loads(line)
    assert f"1 shard per rank, {WORLD} ranks (gloo)" in rec["metric"]
    assert rec["n_devices"] == WORLD and rec["value"] > 0
    assert rec["gps_1dev"] > 0 and rec["gps_ndev"] > 0


def test_gloo_auto_without_flip_and_roll(ranks):
    """GSPMD auto on DTensors where DTensor has no strategy for flip and
    roll (PyTorch 2.11): the port's own strategies run, and the result
    equals the global program in one process bit for bit."""
    want = cli.run(auto_cfg(), device="cpu")
    for r in range(WORLD):
        got = torch.load(ranks / f"auto.rank{r}.pt")
        assert "the global program on DTensors" in got["path"]
        assert got["own"] == [True, True]
        assert got["step"] == want.state.step
        for f, x in got["state"].items():
            assert torch.equal(x, getattr(want.state, f)), f


def test_gloo_auto_fault_breaks(ranks):
    """Phase 16's planted fault of auto (each rank's columns rolled within
    the rank, MC_AUTO_FAULT) moves the result far past MC_AUTO_TOL."""
    want = cli.run(auto_cfg(), device="cpu").state
    got = torch.load(ranks / "auto_fault.rank0.pt")
    diff = {f: float((x - getattr(want, f)).abs().max())
            for f, x in got.items() if f in cs.MC_AUTO_TOL}
    assert [f for f, d in diff.items() if d > cs.MC_AUTO_TOL[f]], diff


def test_partial_and_mixed_sets_refused(ranks, tmp_path):
    """A set without ``.p2`` does not cover the fields; a set whose files
    hold different steps is from two saves: both are refused."""
    name = RUNS[0][0]
    src = ranks / name / "restart.npz"
    cfg = mc_cfg(RUNS[0][1])
    part = tmp_path / "part"
    part.mkdir()
    for r in (0, 1, 3):
        shutil.copy(f"{src}.p{r}", part)
    with pytest.raises(ValueError, match="do not cover"):
        load_checkpoint(str(part / "restart.npz"), cfg, device="cpu")
    mixed = tmp_path / "mixed"
    shutil.copytree(ranks / name, mixed)
    with np.load(f"{src}.p2") as z:
        leaves = dict(z)
    leaves["step"] = leaves["step"] + 1
    np.savez(mixed / "restart.npz.p2.tmp.npz", **leaves)
    os.replace(mixed / "restart.npz.p2.tmp.npz", mixed / "restart.npz.p2")
    with pytest.raises(ValueError, match="disagree on 'step'"):
        load_checkpoint(str(mixed / "restart.npz"), cfg, device="cpu")


# ---------------------------------------------------------------------------
# Phase 16's pure helpers
# ---------------------------------------------------------------------------

def test_multicard_cases():
    """Every case runs on a mesh of the phase's four ranks, in the schedule
    its name says; its unsharded run is the 1x1 run of phases 8, 12 and
    14 (or phase 8's grid over (c)'s 50 steps)."""
    cases = list(cs.MC_CLI_RUNS) + list(cs.MC_RUNS)
    names = [n for n, _ in cases]
    assert len(set(names)) == len(names) and cs.MC_RESUMED not in names
    refs = {tuple(cs.UNSHARDED_ARGV), tuple(cs.B5_UNSHARDED_ARGV),
            tuple(cs.JNP_UNSHARDED_ARGV),
            tuple(cs.on_mesh(cs.MC_B4_50_ARGV, 1, 1))}
    meshes = set()
    for name, argv in cases:
        cfg = cs.argv_config(argv)
        sh = cfg.sharding
        meshes.add((sh.mesh_lat, sh.mesh_lon))
        assert sh.mesh_lat * sh.mesh_lon == cs.MC_WORLD, name
        assert sh.halo_overlap == ("overlap" in name), name
        assert (cfg.backend == "jnp") == name.startswith("jnp"), name
        ref = cs.unsharded_argv(argv)
        assert tuple(ref) in refs, name
        cfg1 = cs.argv_config(ref)
        assert (cfg1.sharding.mesh_lat, cfg1.sharding.mesh_lon) == (1, 1)
        assert dataclasses.replace(cfg1, sharding=sh) == cfg, name
    assert meshes == {(2, 2), (1, 4), (4, 1)}
    assert [cs.argv_config(dict(cs.MC_RUNS)[f"jnp_2x2_{m}"]).sharding.mode
            for m in ("shard_map", "auto")] == ["shard_map", "auto"]
    assert cs.MC_JNP_FAULT in cs.JNP_MESH_FAULTS
    assert [f for f, _ in cs.MC_FAULTS][0] == "none (sound)"


def test_multicard_kernel_cases():
    """Every shape of (h) is a block of a mesh that a counted run of the
    worker takes, and each variant timed on it is one that those runs
    launch; the 2x2 blocks have both strips, the 1x4 block none."""
    runs = dict(cs.MC_RUNS, **{cs.MC_RESUMED: cs.MC_CLI_RUNS[0][1]})
    keys = cs.read_counts().keys()
    timed = set()
    for suffix, n, blocks, plan, names in cs.MC_KERNEL_CASES:
        cfgs = [cs.argv_config(runs[r]) for r in names]
        for cfg in cfgs:
            sh = cfg.sharding
            assert f"b{n}_{sh.mesh_lat}x{sh.mesh_lon}" == suffix
            assert cfg.grid == baseline_config(n).grid
        assert {b[1] for b in blocks} == {(sh.mesh_lat, sh.mesh_lon)}
        assert {name for name, _ in plan} == {b[0] for b in blocks}
        variants = [v for _, vs in plan for v in vs]
        assert len(set(variants)) == len(variants)
        launched = {k for cfg in cfgs for k, v in
                    cs.want_counts(cfg, 10, keys).items() if v}
        assert set(variants) <= launched, suffix
        timed.add((suffix, frozenset(variants)))
    strips = {s: {v for v in vs if "strip" in v} for s, vs in timed}
    assert strips["b4_1x4"] == set()
    assert len(strips["b4_2x2"]) == len(strips["b4_4x1"]) == 4


def test_auto_bounds():
    """auto's bound of each field is 4x the card's reading, and no bound
    is below the bit-for-bit runs' (JNP_MESH_TOL)."""
    assert cs.MC_AUTO_TOL.keys() == cs.JNP_MESH_TOL.keys()
    for f, t in cs.MC_AUTO_TOL.items():
        assert t >= cs.JNP_MESH_TOL[f]
        assert t >= 4 * cs.MC_AUTO_READ.get(f, 0)
    x = torch.arange(12.0).reshape(3, 4)
    for shift in (1, -1):
        assert torch.equal(cs.roll_within_rank(shift)(x),
                           torch.roll(x, shift, dims=-1))


@pytest.mark.parametrize("baseline", (4, 5))
def test_mesh_namelist(baseline, tmp_path):
    """The bench's namelist is the preset on a 2x2 mesh (the file's run
    length aside, which bench does not read)."""
    path = cs.mesh_namelist(baseline, 2, 2, str(tmp_path / "m.toml"))
    cfg = baseline_config(baseline)
    want = cfg.replace(sharding=dataclasses.replace(
        cfg.sharding, mesh_lat=2, mesh_lon=2))
    assert load_config(path).replace(sim_days=cfg.sim_days) == want


def test_want_counts():
    """The launches of a mesh run summed over its shards, the batched slab
    copies in one process and across ranks."""
    keys = cs.read_counts().keys()
    over = cs.want_counts(mc_cfg((2, 2), True), 10, keys)
    assert over["predictor_shard"] == over["corrector_shard"] == 40
    assert over["predictor_south_strip"] == over["corrector_north_strip"] \
        == 20
    assert over["radiation_refreshes"] == 4 * 5
    assert over["predictor_masked"] == 0
    block = cs.want_counts(mc_cfg((1, 4)), 10, keys, start=1)
    assert block["predictor_north_strip"] == 0
    assert block["radiation_refreshes"] == 4 * 5
    one = cs.want_counts(mc_cfg((1, 1)), 3, keys)
    assert (one["predictor_masked"], one["corrector_epilogue"],
            one["predictor_shard"]) == (3, 3, 0)
    assert one["halo_copy_launches"] == one["halo_copy_slabs"] == 0
    # 1x4 in one process: the column refreshes of 12 and 6 fields, 4
    # shards x 2 sides, in 2 + 1 launches of at most 48 slabs
    assert (block["halo_copy_launches"], block["halo_copy_slabs"]) == \
        (10 * 3, 10 * 4 * 2 * (12 + 6))
    # the batched slab copies a step: on 2x2 with overlap 13 launches of
    # 141 slabs a rank; in one process 25 of 348 over the four shards
    # (tests/test_torch_halo_copy.py counts those)
    ranks = cs.want_counts(mc_cfg((2, 2), True), 10, keys, ranks=True)
    assert (ranks["halo_copy_launches"], ranks["halo_copy_slabs"]) == \
        (10 * 4 * 13, 10 * 4 * 141)
    assert (over["halo_copy_launches"], over["halo_copy_slabs"]) == \
        (10 * 25, 10 * 348)
