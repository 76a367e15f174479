"""The sharded packed scan across processes: ``torch.distributed`` with the
gloo backend on the CPU, 4 ranks on a (2, 2) mesh with halo overlap, one
shard per rank (``dist/comm.py::DistExchange``).

Each rank runs the port's ``run`` (two chunks, adaptive dt) on the small
config of ``test_torch_dist.py`` and also checks the split/gather round trip
and the wind that the adaptive dt is taken from (the diagnostics of the
gathered state, so the same on every rank). The ranks do
the same arithmetic on the same blocks as the in-process mesh, so the
gathered result must equal the in-process run bit for bit.

The test spawns its ranks itself, joins them within ``TIMEOUT_S`` and kills
them if they are not done, so that a hang fails it rather than stalling the
suite.
"""

import multiprocessing as mp
import os
import socket

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
        res = cli.run(cfg, device="cpu")
        torch.save(dict(rank=mesh.rank, local=mesh.local_shards,
                        round_trip=round_trip, wind=wind, dts=res.dts,
                        chunks=res.chunks, path=res.path,
                        state={n: getattr(res.state, n) for n in fields}),
                   f"{out}/rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_gloo_ranks_match_in_process(tmp_path):
    import torch

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(tmp_path)))
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
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as the ranks: small work, little CPU
    try:
        _compare(tmp_path)
    finally:
        torch.set_num_threads(threads)


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
        for n in sharding.STATE_FIELDS:
            assert torch.equal(x["state"][n], getattr(want.state, n)), n
            np.testing.assert_array_equal(x["state"][n].numpy(),
                                          got[0]["state"][n].numpy())
