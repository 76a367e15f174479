"""The plain backend on a device mesh across processes: ``torch.distributed``
with the gloo backend on the CPU, 4 ranks on a (2, 2) mesh, one shard per
rank.

Each rank runs the small config of ``test_torch_halo.py`` (physics on)
through ``make_chunk_runner`` in both sharding modes: ``shard_map`` (the
per-operator halo path, each shift a message to a neighbour rank,
``dist/comm.py::DistEdges``) and ``auto`` (the global program on DTensors,
``dist/sharding.py::to_dtensors``). Both must equal the in-process run of
the same config at rtol=atol=1e-12. Then each rank runs the command line,
``run --multihost --backend jnp`` in both modes with an out-dir: the final
checkpoint is one file per rank, which the reference's loader and the
port's reassemble into the state of the same run in one process.

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
N_STEPS = 3
MODES = ("shard_map", "auto")
TOL = dict(rtol=1e-12, atol=1e-12)
CLI_ARGV = ["run", "--nx", "32", "--ny", "16", "--nz", "4", "--physics",
            "all", "--days", "0.02", "--out-every-hours", "0.2", "--dtype",
            "float64", "--device", "cpu", "--backend", "jnp",
            "--mesh-lat", str(MESH[0]), "--mesh-lon", str(MESH[1])]


def mp_cfg(mode):
    from climate_model_tpu_torch.core import config as tcfg
    phys = tcfg.PhysicsConfig(microphysics=True, radiation=True,
                              surface=True, turbulence=True,
                              rad_every_steps=2)
    return tcfg.ModelConfig(
        grid=tcfg.GridConfig(nx=32, ny=16, nz=4), physics=phys,
        dtype="float64", backend="jnp",
        sharding=tcfg.ShardingConfig(mesh_lat=MESH[0], mesh_lon=MESH[1],
                                     mode=mode))


def _rank(rank: int, ports: tuple, out: str):
    # lowest priority and imports inside, as in test_torch_dist_mp.py
    os.nice(19)
    import torch
    import torch.distributed as tdist

    from climate_model_tpu_torch import cli
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.model import make_chunk_runner

    torch.set_num_threads(1)
    tdist.init_process_group("gloo",
                             init_method=f"tcp://localhost:{ports[0]}",
                             rank=rank, world_size=WORLD)
    got = {}
    try:
        for mode in MODES:
            cfg = mp_cfg(mode)
            s, f, g = initialize(cfg, device="cpu")
            res = make_chunk_runner(cfg, N_STEPS)(s, g, f)
            got[mode] = {n: getattr(res, n)
                         for n in sharding.STATE_FIELDS + ("t", "step")}
    finally:
        tdist.destroy_process_group()
    # the command line initialises its own process group from the
    # launcher's environment
    os.environ.update(MASTER_ADDR="localhost",
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    for i, mode in enumerate(MODES):
        os.environ["MASTER_PORT"] = str(ports[1 + i])
        rc = cli.main(CLI_ARGV + ["--sharding-mode", mode, "--multihost",
                                  "--out-dir", f"{out}/cli_{mode}",
                                  "--no-nc"])
        got[f"cli_{mode}_rc"] = rc
    torch.save(got, f"{out}/rank{rank}.pt")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory the ranks wrote to, once they all exited 0."""
    out = tmp_path_factory.mktemp("halo_ranks")
    ctx = mp.get_context("spawn")
    ports = tuple(_free_port() for _ in range(1 + len(MODES)))
    procs = [ctx.Process(target=_rank, args=(r, ports, str(out)))
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


@pytest.fixture
def one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as the ranks: small work, little CPU
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", MODES)
def test_gloo_plain_mesh_matches_in_process(ranks, one_thread, mode):
    import numpy as np
    import torch

    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.model import make_chunk_runner

    cfg = mp_cfg(mode)
    s, f, g = initialize(cfg, device="cpu")
    want = make_chunk_runner(cfg, N_STEPS)(s, g, f)     # in one process
    for r in range(WORLD):
        got = torch.load(ranks / f"rank{r}.pt")[mode]
        assert got["step"] == want.step == N_STEPS
        for n in sharding.STATE_FIELDS + ("t",):
            np.testing.assert_allclose(got[n].numpy(),
                                       getattr(want, n).numpy(),
                                       err_msg=f"{n} rank {r}", **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_gloo_cli_checkpoint_set(ranks, one_thread, mode):
    """``run --multihost --backend jnp``: every rank exits 0 and writes its
    shard's file of the checkpoint set; the reference's loader and the
    port's reassemble the set into the final state of the same run in one
    process."""
    import numpy as np
    import torch

    from climate_model_tpu.io.checkpoint import load_checkpoint_ex
    from climate_model_tpu_torch import cli
    from climate_model_tpu_torch.dist import sharding
    from climate_model_tpu_torch.io.checkpoint import load_checkpoint

    from .test_torch_core import jax_cfg

    assert all(torch.load(ranks / f"rank{r}.pt")[f"cli_{mode}_rc"] == 0
               for r in range(WORLD))
    run = ranks / f"cli_{mode}"
    assert sorted(os.listdir(run)) == sorted(
        ["metrics.jsonl"] + [f"restart.npz.p{r}" for r in range(WORLD)])
    argv = CLI_ARGV + ["--sharding-mode", mode]
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    want = cli.run(cfg, device="cpu").state               # in one process
    path = str(run / "restart.npz")
    ref, mismatch = load_checkpoint_ex(path, jax_cfg(cfg))
    assert mismatch is None
    mine = load_checkpoint(path, cfg, device="cpu")
    assert mine.step == int(ref.step) == want.step
    for n in sharding.STATE_FIELDS + ("t",):
        w = getattr(want, n).numpy()
        np.testing.assert_allclose(getattr(mine, n).numpy(), w, err_msg=n,
                                   **TOL)
        np.testing.assert_array_equal(np.asarray(getattr(ref, n)),
                                      getattr(mine, n).numpy(), err_msg=n)
