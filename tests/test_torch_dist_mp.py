"""The sharded packed scan across processes: ``torch.distributed`` with the
gloo backend on the CPU, 4 ranks on a (2, 2) mesh with halo overlap, one
shard per rank (``dist/comm.py::DistExchange``).

Each rank runs the port's ``run`` (two chunks, adaptive dt) on the small
config of ``test_torch_dist.py``, with an out-dir, and also checks the
split/gather round trip and the wind that the adaptive dt is taken from (the
diagnostics of the gathered state, so the same on every rank). The ranks do
the same arithmetic on the same blocks as the in-process mesh, so the
gathered result must equal the in-process run bit for bit. The run's final
checkpoint is one file per rank (``restart.npz.p0`` to ``.p3``), which the
reference's loader and the port's reassemble into the gathered state; rank 0
alone writes the metrics and NetCDF files.

A module fixture spawns the ranks once, joins them within ``TIMEOUT_S`` and
kills them if they are not done, so that a hang fails the tests rather than
stalling the suite.
"""

import multiprocessing as mp
import os
import socket

import pytest

WORLD = 4
MESH = (2, 2)
TIMEOUT_S = 120


def mp_cfg():
    from climate_model_tpu_torch.core import config as tcfg
    phys = tcfg.PhysicsConfig(microphysics=True, radiation=True,
                              surface=True, turbulence=True,
                              rad_every_steps=2)
    return tcfg.ModelConfig(
        grid=tcfg.GridConfig(nx=32, ny=16, nz=8), physics=phys,
        numerics=tcfg.NumericsConfig(adaptive_dt=True),
        dtype="float64", backend="pallas", sim_days=0.05,
        out_every_hours=0.6,
        sharding=tcfg.ShardingConfig(mesh_lat=MESH[0], mesh_lon=MESH[1],
                                     mode="shard_map", halo_overlap=True))


def spiked(state):
    """``state`` with one 150 m/s u in the interior of shard 3 only."""
    u = state.u.clone()
    u[2, 12, 20] = 150.0
    return state.replace(u=u)


def max_wind(cfg, mesh, state, grid, forcing) -> float:
    """The wind ``cli.run`` takes the adaptive dt from: the diagnostics of
    ``state`` split over ``mesh`` and gathered back."""
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.io.metrics import diagnostics
    whole = sharding.gather(sharding.shard(mesh, state, grid, forcing))
    return diagnostics(whole, grid, forcing, cfg).max_wind


def _rank(rank: int, port: int, out: str):
    # The ranks yield the CPU to the test run around them: they start while
    # other tests run, and the JAX package's 8-device tests deadlock in
    # XLA's in-process collectives when their threads are starved. Hence
    # the lowest priority first, and this module's imports inside the
    # functions (a spawned rank imports the module before it runs this).
    os.nice(19)
    import torch
    import torch.distributed as tdist

    from climate_model_tpu_torch import cli
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.dist.mesh import make_mesh

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=WORLD)
    try:
        fields = sharding.STATE_FIELDS
        cfg = mp_cfg()
        s, f, g = initialize(cfg, device="cpu")
        mesh = make_mesh(cfg, device="cpu")
        ss = sharding.shard(mesh, s, g, f)
        back = sharding.gather(ss)
        round_trip = all(torch.equal(getattr(back, n), getattr(s, n))
                         for n in fields)
        wind = max_wind(cfg, mesh, spiked(s), g, f)
        res = cli.run(cfg, device="cpu", out_dir=f"{out}/run")
        torch.save(dict(rank=mesh.rank, local=mesh.local_shards,
                        round_trip=round_trip, wind=wind, dts=res.dts,
                        chunks=res.chunks, path=res.path,
                        state={n: getattr(res.state, n)
                               for n in fields + ("t", "step")}),
                   f"{out}/rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory the ranks wrote to, once they all exited 0."""
    out = tmp_path_factory.mktemp("ranks")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(out)))
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


def test_gloo_ranks_match_in_process(ranks):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as the ranks: small work, little CPU
    try:
        _compare(ranks)
    finally:
        torch.set_num_threads(threads)


def test_gloo_checkpoint_set(ranks):
    """One checkpoint file per rank, each its shard's interior under global
    offsets; the reference's loader and the port's reassemble the set into
    the gathered state bit for bit. Rank 0 alone wrote metrics and NetCDF
    files, one a chunk."""
    import numpy as np
    import torch

    from climate_model_tpu.io.checkpoint import load_checkpoint_ex
    from climate_model_tpu_torch.io.checkpoint import load_checkpoint

    from .test_torch_core import jax_cfg

    run = ranks / "run"
    got = torch.load(ranks / "rank0.pt")
    n_files = len(got["chunks"])
    assert sorted(os.listdir(run)) == sorted(
        ["constants.nc", "metrics.jsonl"]
        + [f"out_{i:04d}.nc" for i in range(n_files)]
        + [f"restart.npz.p{r}" for r in range(WORLD)])
    assert len(open(run / "metrics.jsonl").readlines()) == n_files
    cfg = mp_cfg()
    ny, nx = cfg.grid.ny // MESH[0], cfg.grid.nx // MESH[1]
    with np.load(run / "restart.npz.p3") as z:
        assert z[f"u@0,{ny},{nx}"].shape == (cfg.grid.nz, ny, nx)
        assert z[f"tsurf@{ny},{nx}"].shape == (ny, nx)
    path = str(run / "restart.npz")
    ref, mismatch = load_checkpoint_ex(path, jax_cfg(cfg))
    assert mismatch is None
    mine = load_checkpoint(path, cfg, device="cpu")
    for n, want in got["state"].items():
        want = np.asarray(want.numpy() if isinstance(want, torch.Tensor)
                          else want)
        np.testing.assert_array_equal(np.asarray(getattr(ref, n)), want,
                                      err_msg=n)
        x = getattr(mine, n)
        np.testing.assert_array_equal(
            x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
            want, err_msg=n)


def _compare(tmp_path):
    import numpy as np
    import torch

    from climate_model_tpu_torch import cli
    from climate_model_tpu_torch.core.grid import adaptive_cfl_dt
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.dist.mesh import make_mesh

    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    assert [(g["rank"], g["local"]) for g in got] == \
        [(r, [r]) for r in range(WORLD)]
    assert all(g["round_trip"] for g in got)
    assert "1 shard per rank, 4 ranks (gloo)" in got[0]["path"]

    cfg = mp_cfg()
    s, f, g = initialize(cfg, device="cpu")
    assert [x["wind"] for x in got] == [150.0] * WORLD
    mesh = make_mesh(cfg, device="cpu")
    assert max_wind(cfg, mesh, spiked(s), g, f) == 150.0
    assert adaptive_cfl_dt(1e5, 0.5, 150.0) < adaptive_cfl_dt(1e5, 0.5, 99.)

    want = cli.run(cfg, device="cpu")          # all shards in this process
    assert len(want.chunks) >= 2
    for x in got:
        assert x["dts"] == want.dts and x["chunks"] == want.chunks
        assert x["state"]["step"] == want.state.step
        for n in sharding.STATE_FIELDS + ("t",):
            assert torch.equal(x["state"][n], getattr(want.state, n)), n
            np.testing.assert_array_equal(x["state"][n].numpy(),
                                          got[0]["state"][n].numpy())
