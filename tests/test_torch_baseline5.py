"""BASELINE #5's decomposition on the CPU (fp64, all shards in one process):
the sharded packed scan on #5's 4x8 mesh, and the run command's #5 preset.

On 4x8 the two middle lat rows of shards have a lat seam on both sides:
24 seams of seam strips a step with halo overlap, against the 4 of #4's
2x4 mesh. #5's physics and numerics run on a 64x32x8 grid, just large
enough for overlap (``ny / 4 >= NY_S + NY_N``), with radiation every 2
steps, for 4 steps from the initial state, blocking and with overlap. Each
is held against the port's unsharded packed scan at rtol=atol=1e-13 and
against the JAX package's unsharded packed scan (its Pallas kernel in
interpret mode) at rtol=1e-9, atol=1e-10; the reference cannot run 32
virtual devices here. On the CPU the kernel wrappers take their plain
versions and count nothing, so the launches a step are counted at the
runner's calls of the wrappers, by ``part``.
"""

import collections
import dataclasses
import functools

import numpy as np
import pytest
import torch

from climate_model_tpu import model as jmodel
from climate_model_tpu.core import init as jinit
from climate_model_tpu_torch import cli
from climate_model_tpu_torch import model as tmodel
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.dist import mesh as tmesh
from climate_model_tpu_torch.dist import packed_halo, sharding

from .test_torch_core import jax_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

N_STEPS = 4
FIELDS = sharding.STATE_FIELDS
REF_TOL = dict(rtol=1e-9, atol=1e-10)
SELF_TOL = dict(rtol=1e-13, atol=1e-13)
MESH = (4, 8)


def b5_small(mesh=(1, 1), overlap=False):
    b5 = tcfg.baseline_config(5)
    return b5.replace(
        grid=dataclasses.replace(b5.grid, nx=64, ny=32, nz=8),
        dtype="float64",
        physics=dataclasses.replace(b5.physics, rad_every_steps=2,
                                    rad_every_hours=0.0),
        sharding=dataclasses.replace(b5.sharding, mesh_lat=mesh[0],
                                     mesh_lon=mesh[1],
                                     halo_overlap=overlap))


@functools.lru_cache(maxsize=None)
def port_unsharded():
    cfg = b5_small()
    s, f, g = initialize(cfg, device="cpu")
    return tmodel.make_chunk_runner(cfg, N_STEPS)(s, g, f)


def counted_run(monkeypatch, cfg):
    """The sharded run of ``cfg`` through ``make_chunk_runner``, and the
    calls of each wrapper by part."""
    calls = collections.Counter()

    def spy(fn):
        def call(*a, part="grid", **k):
            calls[f"{fn.__name__}_{part}"] += 1
            return fn(*a, part=part, **k)
        return call

    for name in ("predictor", "corrector"):
        monkeypatch.setattr(packed_halo, name,
                            spy(getattr(packed_halo, name)))
    s, f, g = initialize(cfg, device="cpu")
    out = tmodel.make_chunk_runner(cfg, N_STEPS)(s, g, f)
    assert out.step == N_STEPS
    return out, dict(calls)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["blocking", "overlap"])
def test_4x8_matches_unsharded(monkeypatch, overlap):
    out, calls = counted_run(monkeypatch, b5_small(MESH, overlap))
    shards = MESH[0] * MESH[1]
    seams = MESH[1] * (MESH[0] - 1) if overlap else 0
    want = {f"{fn}_{part}": n * N_STEPS
            for fn in ("predictor", "corrector")
            for part, n in (("shard", shards), ("south_strip", seams),
                            ("north_strip", seams)) if n}
    assert calls == want
    base = port_unsharded()
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   getattr(base, name).numpy(),
                                   err_msg=name, **SELF_TOL)


def test_4x8_matches_reference(monkeypatch):
    """The port's 4x8 run with overlap against the JAX package's unsharded
    packed scan, and the port's unsharded run against it too."""
    out, _ = counted_run(monkeypatch, b5_small(MESH, True))
    cfg = jax_cfg(b5_small())
    monkeypatch.setenv("CLIMATE_TPU_PACKED_SCAN", "1")
    js, jf, jg = jinit.initialize(cfg)
    ref = jmodel.make_chunk_runner(cfg, N_STEPS)(js, jg, jf)
    assert int(ref.step) == N_STEPS
    base = port_unsharded()
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(out, name).numpy(), r,
                                   err_msg=name, **REF_TOL)
        np.testing.assert_allclose(getattr(base, name).numpy(), r,
                                   err_msg=name, **REF_TOL)


def test_4x8_layouts():
    """Which shards have a lat seam, and on which side: the polar rows of
    shards one, the two middle rows both; the strips' rows and the
    exchange's neighbours follow."""
    cfg = b5_small(MESH, True)
    s, f, g = initialize(cfg, device="cpu")
    mesh = tmesh.make_mesh(cfg, device="cpu")
    ss = sharding.shard(mesh, s, g, f)
    ghosts = [(lay.gs, lay.gn, lay.gx) for lay in ss.layouts]
    assert ghosts == ([(0, 3, 3)] * 8 + [(3, 3, 3)] * 16 + [(3, 0, 3)] * 8)
    for shard, lay in enumerate(ss.layouts):
        nb = ss.exchange.neighbours(lay)
        a, b = divmod(shard, MESH[1])
        assert nb["west"] == a * 8 + (b - 1) % 8
        assert nb["east"] == a * 8 + (b + 1) % 8
        assert nb["south"] == (None if a == 0 else shard - 8)
        assert nb["north"] == (None if a == 3 else shard + 8)
        strips = [packed_halo.SeamStrip(side, lay, ss.grids[shard],
                                        ss.forcings[shard],
                                        packed_halo.row_mask(
                                            lay, torch.float64, "cpu"),
                                        ss.halo)
                  for side, has in (("south", lay.gs), ("north", lay.gn))
                  if has]
        assert [st.part for st in strips] == \
            (["south_strip"] if lay.gs else []) + \
            (["north_strip"] if lay.gn else [])
        for st in strips:
            # 9 rows: fresh ghosts + the seam's rows + context
            assert st.r1 - st.r0 == 9
            assert 0 <= st.r0 < st.r1 <= lay.ny_b
    # the strips' rows a step: 24 seams, each with a south and a north strip
    assert sum(bool(lay.gs) for lay in ss.layouts) == \
        sum(bool(lay.gn) for lay in ss.layouts) == 24
    back = sharding.gather(ss)
    for name in FIELDS:
        assert torch.equal(getattr(back, name), getattr(s, name)), name


def test_cli_baseline5_preset():
    """``run --baseline 5`` takes #5's grid on its 4x8 mesh, blocking (the
    preset, as the reference's, leaves halo overlap off); ``--halo-overlap``
    and the 1x1 override select the other two runs of ``chip_smoke.py``
    phase 14."""
    p = cli.make_parser()
    b5 = cli.build_config(p.parse_args(["run", "--baseline", "5"]))
    assert (b5.grid.nx, b5.grid.ny, b5.grid.nz) == (1440, 720, 32)
    assert (b5.backend, b5.sharding.mesh_lat, b5.sharding.mesh_lon,
            b5.sharding.mode, b5.sharding.halo_overlap) == \
        ("pallas", 4, 8, "shard_map", False)
    assert b5.physics.rad_every_steps == 435          # hourly at 8.27 s
    mesh = tmesh.Mesh(4, 8, torch.device("cpu"))
    assert cli.describe_path(b5, mesh) == (
        "sharded packed scan  mesh=4x8 (shard_map, blocking, 32 shards on "
        "1 device (cpu))")
    ov = cli.build_config(p.parse_args(["run", "--baseline", "5",
                                        "--halo-overlap"]))
    assert cli.describe_path(ov, mesh) == (
        "sharded packed scan  mesh=4x8 (shard_map, halo overlap, 32 shards "
        "on 1 device (cpu))")
    one = cli.build_config(p.parse_args(["run", "--baseline", "5",
                                         "--mesh-lat", "1", "--mesh-lon",
                                         "1", "--days", "0.25"]))
    assert (one.sharding.mesh_lat, one.sharding.mesh_lon) == (1, 1)
    assert one.grid == b5.grid and one.sim_days == 0.25
    assert cli.describe_path(one) == \
        "packed scan (corrector with physics epilogue)"
