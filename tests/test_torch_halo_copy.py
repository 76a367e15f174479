"""The ghost exchange's batched slab copy (``kernels/halo_copy.py``) on the
CPU.

``slab_copy_kernel`` runs only on the card. What it does with its
descriptors is emulated here with PyTorch indexing (``Emulator``): each
descriptor's pointers resolved to the storage they lie in, viewed as 32-bit
words, and the grid's blocks walked as the kernel walks them (a block finds
its slab by bisection of the block0 prefix; a warp a unit of a wide line, a
thread a narrow line). With the emulator in place of the launch, the card's
path of ``copy_slabs`` runs on CPU tensors, and:

* the exchange's packs and unpacks (``comm._pack_into``, ``comm._unpack``),
  both exchanges' refreshes, and the seam strips' cuts and splices
  (``SeamStrip.cut``, ``SeamStrip.merge``) write the bits of the plain
  copies, on the 2x2 (a 2-wide lon ring), 1x4, 4x1 and 2x4 meshes, polar
  sides included, with 3-D and 2-D fields in float32 and float64;
* every launch's descriptors fit the kernel's parameters, and its grid is
  the sum of the slabs' blocks;
* a captured step (the stand-in capture of ``test_torch_graphs.py``) counts
  the launches and slabs that its layout implies, and equals the eager run
  bit for bit.
"""

import dataclasses
import threading

import pytest
import torch

from climate_model_tpu_torch import trace
from climate_model_tpu_torch.dist import comm, packed_halo, sharding
from climate_model_tpu_torch.dist.sharding import STATE_FIELDS
from climate_model_tpu_torch.kernels import halo_copy as hc

from ._torch_threads import torch_threads  # noqa: F401 (fixture)
from .test_torch_graphs import StandInCapture, small_cfg
from .test_torch_multicard import TagBlind, garbled_blocks, on_ranks

MESHES = ((2, 2), (1, 4), (4, 1), (2, 4))
DTYPES = (torch.float32, torch.float64)
PROG = len(packed_halo.PROG_FIELDS + packed_halo.RAD_FIELDS)   # 12 fields
DYN = len(packed_halo.DYN_FIELDS)                              # 6
CORR = DYN + len(packed_halo.EPI_FIELDS)                       # 9
CUT = 6             # the 3-D fields of a State, whose rows a strip copies


class Emulator:
    """``slab_copy_kernel`` by PyTorch indexing. ``slab`` records the
    storage of every tensor it describes (the pointers' only way back to
    tensors); ``launch`` takes the place of ``halo_copy._launch``, checks
    the launch's descriptors against the kernel's parameters and copies
    block by block. ``launches`` lists (thread name, slabs) of each
    launch."""

    def __init__(self):
        self.storages = {}
        self.launches = []
        self.lock = threading.Lock()
        self.real_slab = hc.slab

    def slab(self, dst, src):
        with self.lock:
            for t in (dst, src):
                st = t.untyped_storage()
                self.storages[st.data_ptr()] = st
        return self.real_slab(dst, src)

    def words(self, ptr: int):
        """The words of the storage ``ptr`` lies in, and ptr's offset."""
        with self.lock:
            sts = list(self.storages.items())
        for base, st in sts:
            if base <= ptr < base + st.nbytes():
                assert (ptr - base) % 4 == 0
                return (torch.empty(0, dtype=torch.int32).set_(st),
                        (ptr - base) // 4)
        raise AssertionError(f"pointer {ptr:#x} in no described tensor")

    def launch(self, descs, n_blocks: int, dev):
        assert descs.dtype == hc.SLAB and descs.dtype.itemsize == 64
        assert 1 <= len(descs) <= hc.MAX_SLABS
        # ``Batch``: the descriptors and their count, 8-byte aligned
        assert len(descs) * descs.dtype.itemsize + 8 <= hc.PARAM_BYTES
        per = [hc.blocks(int(d["nz"]), int(d["rows"]), int(d["cols"]))
               for d in descs]
        assert all(b >= 1 for b in per)
        assert descs["block0"].tolist() == [sum(per[:i])
                                            for i in range(len(per))]
        assert n_blocks == sum(per)
        b0 = descs["block0"].tolist()
        for block in range(n_blocks):
            lo, hi = 0, len(descs) - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if b0[mid] <= block else (lo, mid - 1)
            self.block(descs[lo], block - b0[lo])
        with self.lock:
            self.launches.append((threading.current_thread().name,
                                  len(descs)))

    def block(self, d, local: int):
        nz, rows, cols = int(d["nz"]), int(d["rows"]), int(d["cols"])
        src, so = self.words(int(d["src"]))
        dst, do = self.words(int(d["dst"]))
        lines = nz * rows
        if cols >= hc.WIDE_WORDS:
            segs = -(-cols // hc.SEG_WORDS)
            warps = hc.THREADS // 32
            units = [(u // segs, (u % segs) * hc.SEG_WORDS)
                     for u in range(local * warps, (local + 1) * warps)
                     if u < lines * segs]
        else:
            units = [(line, 0) for line in
                     range(local * hc.THREADS, (local + 1) * hc.THREADS)
                     if line < lines]
        for line, c0 in units:
            z, r = divmod(line, rows)
            n = min(hc.SEG_WORDS, cols - c0)
            s = so + z * int(d["sz"]) + r * int(d["sr"]) + c0
            t = do + z * int(d["dz"]) + r * int(d["dr"]) + c0
            dst[t:t + n] = src[s:s + n]


@pytest.fixture
def on_card(monkeypatch):
    """``copy_slabs`` takes the card's path on CPU tensors, with the
    emulator in place of the launch."""
    emu = Emulator()
    monkeypatch.setattr(hc, "_on_card", lambda dev: True)
    monkeypatch.setattr(hc, "slab", emu.slab)
    monkeypatch.setattr(hc, "_launch", emu.launch)
    saved = trace.counts()
    yield emu
    trace.reset_counts(saved)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(bits(x), bits(y))
                                    for x, y in zip(a, b))


def typed(blocks: list, dtype) -> list:
    return [[x.to(dtype) for x in bs] for bs in blocks]


def edge_slabs(lay, blocks: list) -> tuple:
    """A rank's sends and receives of a column refresh and of a row
    exchange as ``DistExchange`` posts them: (peer, tag, slabs)."""
    ex = comm.Exchange
    sends, recvs = [], []
    if lay.nx_l < lay.nx:
        for k, side in enumerate(("east", "west")):
            sends.append((0, k, [x[..., ex._col_src(lay, side)]
                                 for x in blocks]))
            recvs.append((0, k, [x[..., ex._col_dst(lay, side)]
                                 for x in blocks]))
    for k, (side, has) in enumerate((("south", lay.gs), ("north", lay.gn))):
        if has:
            dst = ex._row_dst(lay, side)
            src = ex._row_src(lay, side, dst.stop - dst.start)
            sends.append((0, 2 + k, [x[..., src, :] for x in blocks]))
            recvs.append((0, 2 + k, [x[..., dst, :] for x in blocks]))
    return sends, recvs


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pack_and_unpack_equal_the_plain_copies(shape, dtype, on_card):
    """Every rank's packs of its edge slabs, and unpacks into its ghosts,
    through the emulated kernel, bit for bit with the plain copies."""
    _, lays, blocks, _ = garbled_blocks(shape)
    blocks = typed(blocks, dtype)
    for lay, bs in zip(lays, blocks):
        sends, recvs = edge_slabs(lay, bs)
        assert sends and any(x.dim() == 2 for _, _, xs in sends for x in xs)
        sizes = [sum(x.numel() for x in xs) for _, _, xs in sends]
        got, want = ([torch.full((n,), -1.0, dtype=dtype) for n in sizes]
                     for _ in range(2))
        comm._pack_into(got, sends)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(hc, "_on_card", lambda dev: False)
            comm._pack_into(want, sends)
        assert same(got, want)
        # into the ghosts of copies of the block, from buffers that hold
        # other values (the packed ones reversed)
        ghosts_e = [x.clone() for x in bs]
        ghosts_p = [x.clone() for x in bs]
        bufs = [w.flip(0).clone() for w in want]
        comm._unpack(bufs, edge_slabs(lay, ghosts_e)[1])
        with pytest.MonkeyPatch.context() as m:
            m.setattr(hc, "_on_card", lambda dev: False)
            comm._unpack(bufs, edge_slabs(lay, ghosts_p)[1])
        assert same(ghosts_e, ghosts_p)
        assert not same(ghosts_e, bs)
    assert on_card.launches


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_refreshes_equal_the_plain_copies(shape, dtype, on_card,
                                          monkeypatch):
    """Both exchanges' refreshes through the emulated kernel equal the
    plain ones bit for bit; each ``DistExchange`` rank makes one launch a
    pack and one an unpack of a column refresh and of a row exchange."""
    mesh, lays, blocks, _ = garbled_blocks(shape)
    blocks = typed(blocks, dtype)
    out = {}
    for card in (False, True):
        monkeypatch.setattr(hc, "_on_card", lambda dev, c=card: c)
        local = [[x.clone() for x in bs] for bs in blocks]
        comm.LocalExchange(mesh, lays).refresh(local)
        net = TagBlind()
        monkeypatch.setattr(comm, "tdist", net)

        def rank(r):
            ex = comm.DistExchange(dataclasses.replace(mesh, rank=r), lays)
            mine = [x.clone() for x in blocks[r]]
            ex.refresh([mine])
            return threading.current_thread().name, mine
        res = on_ranks(mesh.size, rank, net)
        out[card] = (local, [m for _, m in res], [t for t, _ in res])
    assert same(sum(out[True][0], []), sum(out[False][0], []))
    assert same(sum(out[True][1], []), sum(out[False][1], []))
    n_lat, n_lon = shape
    fields = len(blocks[0])
    for lay, ident in zip(lays, out[True][2]):
        mine = [n for t, n in on_card.launches if t == ident]
        cols = [2 * fields] * 2 if n_lon > 1 else []
        k = bool(lay.gs) + bool(lay.gn)
        rows = [k * fields] * 2 if n_lat > 1 else []
        assert mine == cols + rows, (lay, mine)


def strips_of(shape, dtype):
    """The blocks of ``small_cfg`` on ``shape`` with halo overlap, and each
    block's seam strips."""
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist.mesh import make_mesh
    cfg = small_cfg(shape, overlap=True)
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, ny=32),     # 8 rows a 4x1 block
        dtype="float32" if dtype == torch.float32 else "float64")
    s, f, g = initialize(cfg, device="cpu")
    ss = sharding.shard(make_mesh(cfg, device="cpu"), s, g, f)
    packed_halo.check_blocks(cfg, ss)
    out = []
    for st, lay, gr, fo in zip(ss.states, ss.layouts, ss.grids,
                               ss.forcings):
        mask = packed_halo.row_mask(lay, st.dtype, st.device)
        out.append((st, [packed_halo.SeamStrip(side, lay, gr, fo, mask,
                                               ss.halo)
                         for side, has in (("south", lay.gs),
                                           ("north", lay.gn)) if has]))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_strips_equal_the_plain_copies(shape, dtype, on_card, monkeypatch):
    """Each seam strip's cut, and its splice over a block, through the
    emulated kernel, bit for bit with the plain copies; a cut copies the
    3-D fields in one launch and leaves the 2-D ones views, as
    ``.contiguous()`` did. A mesh of one lat shard has no strip."""
    blocks = strips_of(shape, dtype)
    assert (shape[0] > 1) == any(strips for _, strips in blocks)
    for state, strips in blocks:
        assert sum(getattr(state, f).dim() == 3 for f in STATE_FIELDS) \
            == CUT
        noisy = state.replace(**{f: torch.randn_like(getattr(state, f))
                                 for f in STATE_FIELDS})
        for st in strips:
            n0 = len(on_card.launches)
            got = st.cut(state)
            assert [n for _, n in on_card.launches[n0:]] == [CUT]
            monkeypatch.setattr(hc, "_on_card", lambda dev: False)
            want = st.cut(state)
            assert same([getattr(got, f) for f in STATE_FIELDS],
                        [getattr(want, f) for f in STATE_FIELDS])
            assert got.colp.data_ptr() == want.colp.data_ptr() \
                == state.colp[st.r0:].data_ptr()
            a, b = (noisy.replace(**{f: getattr(noisy, f).clone()
                                     for f in STATE_FIELDS})
                    for _ in range(2))
            fields = packed_halo.DYN_FIELDS + packed_halo.EPI_FIELDS
            st.merge(b, want, fields)
            monkeypatch.setattr(hc, "_on_card", lambda dev: True)
            n0 = len(on_card.launches)
            st.merge(a, got, fields)
            assert [n for _, n in on_card.launches[n0:]] == [CORR]
            assert same([getattr(a, f) for f in STATE_FIELDS],
                        [getattr(b, f) for f in STATE_FIELDS])
            assert not same([a.u], [noisy.u])


def test_slab_descriptors():
    """A full-width row slab is one run a level, a ghost-column slab a
    narrow line a row, a contiguous slab one run, a strided last dim a line
    an element; float64 counts two words an element; what the kernel
    cannot take is refused."""
    x = torch.zeros(4, 10, 7)
    buf = torch.zeros(4 * 3 * 7)
    rows = hc.slab(buf.view(4, 3, 7), x[:, 2:5, :])
    assert rows[2:] == (0, 70, 0, 21, 1, 4, 21)       # 4 lines of 21 words
    cols = hc.slab(torch.zeros(4, 10, 3), x[..., 1:4])
    assert cols[2:] == (0, 7, 0, 3, 1, 40, 3)         # 40 lines of 3
    one = hc.slab(torch.zeros(10, 7, dtype=torch.float64),
                  torch.ones(10, 7, dtype=torch.float64))
    assert one[2:] == (0, 0, 0, 0, 1, 1, 140)
    col = hc.slab(torch.zeros(4, 10, 1), x[..., 6:])
    assert col[2:] == (0, 7, 0, 1, 1, 40, 1)
    every_other = hc.slab(torch.zeros(4, 10, 4), x[..., ::2])
    assert every_other[2:] == (7, 2, 4, 1, 40, 4, 1)
    assert hc.blocks(1, 40, 3) == 1 and hc.blocks(4, 1, 21) == 1
    assert hc.blocks(32, 1, 2178) == -(-32 * 3 // 8)
    for bad in ((torch.zeros(2, 2, 2, 2), torch.zeros(2, 2, 2, 2)),
                (torch.zeros(3, 4, dtype=torch.float16),) * 2,
                (torch.zeros(4, 3, 4), x[:, 2:5, ::2]),
                (torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.float64))):
        with pytest.raises(ValueError):
            hc.slab(*bad)


def test_plan_splits_at_the_parameter_limit(on_card):
    """More than MAX_SLABS pairs take more launches, in order, each within
    the kernel's parameters, and copy every pair."""
    src = [torch.randn(3, 5, 40) for _ in range(hc.MAX_SLABS + 5)]
    dst = [torch.zeros(3, 2, 40) for _ in src]
    hc.copy_slabs([(d, s[:, 1:3, :]) for d, s in zip(dst, src)])
    assert [n for _, n in on_card.launches] == [hc.MAX_SLABS, 5]
    assert all(torch.equal(d, s[:, 1:3, :]) for d, s in zip(dst, src))
    c = trace.counts()
    assert (c["halo_copy.launches"], c["halo_copy.slabs"]) == \
        (2, hc.MAX_SLABS + 5)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["blocking", "overlap"])
def test_captured_step_counts_its_copies(overlap, on_card):
    """The stand-in capture of a step on 2x2 in one process, through the
    emulated kernel: every capture's delta holds the launches and slabs
    that the layout implies, and the chunk equals the eager run of the
    plain copies bit for bit.

    A step refreshes the 12 prognostic and radiative fields and then the 6
    predicted ones. The column refresh of F fields copies 4 shards x 2
    sides x F slabs, the row exchange 4 x F (one lat neighbour a shard);
    a launch takes at most 48. Under overlap each of the 4 blocks has one
    strip: the predictor's cut (6 3-D fields) and splice (6), the
    corrector's two cuts (6 each) and splice (9)."""
    from climate_model_tpu_torch import graphs, model
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist.mesh import make_mesh
    cfg = small_cfg((2, 2), overlap)
    s, f, g = initialize(cfg, device="cpu")
    n = 5
    trace.reset_counts()

    def blocks():
        return sharding.shard(make_mesh(cfg, device="cpu"), s, g, f)

    graphs.clear_cache()
    try:
        got = graphs.make_graph_runner(cfg, n, capture=StandInCapture)(
            blocks(), g, f)
        (runner,) = graphs.cached_runners()
    finally:
        graphs.clear_cache()
    slabs = [8 * PROG, 4 * PROG, 8 * DYN, 4 * DYN]
    launches = sum(-(-k // hc.MAX_SLABS) for k in slabs)
    if overlap:
        slabs += [4 * (CUT + DYN + 2 * CUT + CORR)]
        launches += 4 * 5
    for key, delta in runner.deltas.items():
        assert delta["halo_copy.launches"] == launches, key
        assert delta["halo_copy.slabs"] == sum(slabs), key
    c = trace.counts()            # the replays'; the captures put back
    assert (c["halo_copy.launches"], c["halo_copy.slabs"]) == \
        (n * launches, n * sum(slabs))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(hc, "_on_card", lambda dev: False)
        want = model.make_chunk_runner(cfg, n, graphs=False)(blocks(), g, f)
    for a, b in zip(got.states, want.states):
        assert same([getattr(a, k) for k in STATE_FIELDS],
                    [getattr(b, k) for k in STATE_FIELDS])


@pytest.mark.parametrize("shape,cut", [
    ((3, 300, 9), (slice(None), slice(None), slice(3, 6))),     # narrow
    ((3, 20, 2100), (slice(None), slice(2, 18), slice(None))),  # wide rows
    ((2, 40, 2100), (slice(None), slice(None), slice(1, 2099))),
], ids=["narrow-4-blocks", "wide-runs", "wide-lines"])
def test_slabs_of_many_blocks(shape, cut, on_card):
    """Slabs that take many blocks each (lines past a block's threads,
    lines of several warp units, one run of many units), beside a
    one-block slab in the same launch: every word copied once, as the
    plain copies do."""
    src = torch.randn(shape)
    small = torch.randn(2, 3, 5)
    got = [torch.zeros(src[cut].shape), torch.zeros(2, 3, 2)]
    pairs = [(got[0], src[cut]), (got[1], small[..., 1:3])]
    hc.copy_slabs(pairs)
    (descs, n), = hc.plan(pairs)
    assert n == descs["block0"][1] + 1 > 2
    assert torch.equal(got[0], src[cut]) and torch.equal(got[1],
                                                         small[..., 1:3])


def test_smoke_gate_on_small_blocks(on_card):
    """``chip_smoke.py``'s phase 19 gate (``halo_copy_check``) at 2x2 with
    halo overlap on 32x16x8 float64 blocks, through the emulated kernel:
    every pack, unpack, cut and splice of ranks 0 and 2 and each extra
    case equal to the per-slab copies bit for bit, and each rank's step
    counted at the launches and slabs that the layout implies."""
    import chip_smoke
    bad = []
    res = chip_smoke.halo_copy_check(small_cfg((2, 2), True),
                                     torch.device("cpu"), bad)
    assert bad == []
    # a column refresh of F fields packs and unpacks 2F slabs, a row
    # exchange F (one lat neighbour)
    step = 6 * (PROG + DYN) + 3 * CUT + DYN + CORR
    assert res["counts"] == {0: (13, step), 2: (13, step)}
    assert step == 141


@pytest.mark.gpu
def test_card_copies_equal_the_plain_ones():
    """On the card: a pack, an unpack, a cut and a splice of #5's 2x2
    blocks' shapes through the kernel, bit for bit with the plain copies,
    one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(32, 363, 726, device=dev, generator=gen)
    y = torch.randn(363, 726, device=dev, generator=gen)
    cases = {
        "pack": [(torch.empty(32, 363, 3, device=dev), x[..., 3:6]),
                 (torch.empty(363, 3, device=dev), y[..., 720:723]),
                 (torch.empty(32, 3, 726, device=dev), x[:, 357:360, :])],
        "unpack": [(x[..., :3], torch.randn(32, 363, 3, device=dev,
                                            generator=gen)),
                   (y[360:, :], torch.randn(3, 726, device=dev,
                                            generator=gen))],
        "cut": [(torch.empty(32, 9, 726, device=dev), x[:, 354:, :])],
        "splice": [(x[:, 357:, :], torch.randn(32, 6, 726, device=dev,
                                               generator=gen)),
                   (y[357:, :], torch.randn(6, 726, device=dev,
                                            generator=gen))],
    }
    for name, pairs in cases.items():
        want = [s.clone() for _, s in pairs]
        saved = trace.counts()
        hc.copy_slabs(pairs)
        torch.cuda.synchronize(dev)
        got = trace.counts() - saved
        trace.reset_counts(saved)
        assert all(torch.equal(bits(d), bits(w)) for (d, _), w in
                   zip(pairs, want)), name
        assert (got["halo_copy.launches"], got["halo_copy.slabs"]) == \
            (1, len(pairs)), name
