"""The port's sharded packed scan (``dist/``) against the JAX package's
``make_packed_sharded_runner`` and against the port's unsharded packed scan
(CPU, fp64, all shards in one process).

The config is the reference's own test config
(``tests/distributed/test_packed_sharded.py:37-40``: 32x16x8, fp64,
``backend='pallas'``, radiation every 2 steps), from the same initial state,
for 4 steps. The reference runs its Pallas kernels in interpret mode on the
8 virtual CPU devices of ``tests/conftest.py``; the port's kernel wrappers
take their plain versions on CPU tensors. Against the reference the
tolerance is that of the port's packed scan against the reference's
(``test_torch_model.py::test_packed_scan_matches_reference``): rtol=1e-9,
atol=1e-10. Against the port's own unsharded run: rtol=atol=1e-13, and
bit for bit on the meshes where that holds.

The reference is run once per physics setting and test session, on its
2x4 mesh with halo overlap (every kind of seam: lat and lon, strips), and
every mesh and schedule of the port is held against that run. The
reference's own tests hold each of its meshes and both schedules within
rtol=1e-12, atol=1e-13 of its single-device run
(``tests/distributed/test_packed_sharded.py``), far inside the tolerance
here. One run instead of one per mesh keeps the CPU load of this file small
beside the reference's own 8-device tests, whose in-process collectives
give up when starved (``ROADMAP.md``, "Reference caveats").
"""

import dataclasses
import fcntl
import functools
import os

import jax
import numpy as np
import pytest
import torch

from climate_model_tpu.core.init import initialize as jinitialize
from climate_model_tpu.dist.mesh import make_mesh as jmake_mesh
from climate_model_tpu.dist.packed_halo import \
    make_packed_sharded_runner as jsharded_runner
from climate_model_tpu.dist.sharding import shard_inputs
from climate_model_tpu_torch import cli
from climate_model_tpu_torch import model as tmodel
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.dist import mesh as tmesh
from climate_model_tpu_torch.dist import sharding
from climate_model_tpu_torch.dist.packed_halo import \
    make_packed_sharded_runner
from climate_model_tpu_torch.kernels import fused_substep as fs

from .test_torch_core import jax_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

N_STEPS = 4
FIELDS = sharding.STATE_FIELDS
REF_TOL = dict(rtol=1e-9, atol=1e-10)
SELF_TOL = dict(rtol=1e-13, atol=1e-13)


def dist_cfg(physics=True, mesh=(1, 1), overlap=False):
    phys = tcfg.PhysicsConfig(microphysics=physics, radiation=physics,
                              surface=physics, turbulence=physics,
                              rad_every_steps=2)
    return tcfg.ModelConfig(
        grid=tcfg.GridConfig(nx=32, ny=16, nz=8), physics=phys,
        dtype="float64", backend="pallas",
        sharding=tcfg.ShardingConfig(mesh_lat=mesh[0], mesh_lon=mesh[1],
                                     mode="shard_map",
                                     halo_overlap=overlap))


REF_MESH = (2, 4)


def reference_run(physics):
    """The JAX package's sharded packed scan on REF_MESH with halo overlap,
    N_STEPS from the initial state, as NumPy arrays."""
    cfg = jax_cfg(dist_cfg(physics, REF_MESH, True))
    state, forcing, grid = jinitialize(cfg)
    jmesh = jmake_mesh(mesh_lat=REF_MESH[0], mesh_lon=REF_MESH[1])
    run = jsharded_runner(cfg, jmesh, grid, n_steps=N_STEPS)
    out = jax.block_until_ready(run(*shard_inputs(jmesh, state, grid,
                                                   forcing)))
    assert int(out.step) == N_STEPS
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    """``reference(physics)``: ``reference_run(physics)``, computed once per
    test session. Under xdist the first worker to need it computes it
    while holding a lock in the directory that all workers share, and
    stores it there for the others."""
    shared = os.environ.get("PYTEST_XDIST_WORKER") is not None
    root = tmp_path_factory.getbasetemp()
    if shared:
        root = root.parent

    @functools.lru_cache(maxsize=None)
    def get(physics):
        path = root / f"torch_dist_reference_{int(physics)}.npz"
        with open(f"{path}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                np.savez(path, **reference_run(physics))
        with np.load(path) as z:
            return {f: z[f] for f in FIELDS}

    return get


@functools.lru_cache(maxsize=None)
def port_unsharded(physics):
    cfg = dist_cfg(physics)
    s, f, g = initialize(cfg, device="cpu")
    return tmodel.make_chunk_runner(cfg, N_STEPS)(s, g, f)


def port_sharded(physics, mesh, overlap):
    """The port's sharded run through ``make_chunk_runner`` (a global
    State in, split over an in-process mesh, gathered back)."""
    cfg = dist_cfg(physics, mesh, overlap)
    s, f, g = initialize(cfg, device="cpu")
    fs.reset_launch_counts()
    out = tmodel.make_chunk_runner(cfg, N_STEPS)(s, g, f)
    assert out.step == N_STEPS
    # on the CPU the wrappers take the plain versions and count nothing
    assert fs.predictor.shard_launches == fs.corrector.shard_launches == 0
    return out


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (4, 2)])
@pytest.mark.parametrize("physics", [False, True])
def test_sharded_matches_reference(reference, mesh_shape, physics):
    out = port_sharded(physics, mesh_shape, False)
    ref = reference(physics)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(), ref[name],
                                   err_msg=f"{name} mesh={mesh_shape}",
                                   **REF_TOL)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("physics", [False, True])
def test_sharded_overlap_matches_reference(reference, mesh_shape, physics):
    out = port_sharded(physics, mesh_shape, True)
    ref = reference(physics)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(), ref[name],
                                   err_msg=f"{name} mesh={mesh_shape}",
                                   **REF_TOL)


# bitwise: whether the run equals the unsharded one bit for bit on this
# CPU; where it does not, the plain PyTorch radiation and moisture loops
# vectorise another block width differently in the last bit
@pytest.mark.parametrize("mesh_shape,overlap,bitwise", [
    ((1, 4), False, True), ((2, 2), False, True), ((4, 2), False, False),
    ((2, 1), True, True), ((2, 2), True, True), ((2, 4), True, False)])
def test_sharded_matches_unsharded(mesh_shape, overlap, bitwise):
    want = port_unsharded(True)
    out = port_sharded(True, mesh_shape, overlap)
    for name in FIELDS:
        a, b = getattr(out, name), getattr(want, name)
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **SELF_TOL)
        if bitwise:
            assert torch.equal(a, b), name


def test_overlap_refuses_thin_shards():
    cfg = dist_cfg(False, (4, 2), True)        # ny_l = 4 < NY_S + NY_N
    s, f, g = initialize(cfg, device="cpu")
    with pytest.raises(ValueError, match="halo_overlap"):
        tmodel.make_chunk_runner(cfg, 1)(s, g, f)


def test_split_gather_round_trip():
    """Blocks carry the true neighbour values in their ghosts (the lon
    seam wraps, a polar side has none), and gather returns the global
    fields bit for bit."""
    cfg = dist_cfg(True, (2, 4))
    s, f, g = initialize(cfg, device="cpu")
    mesh = tmesh.make_mesh(cfg, device="cpu")
    ss = sharding.shard(mesh, s, g, f)
    assert [(lay.gs, lay.gn, lay.gx) for lay in ss.layouts] == \
        [(0, 3, 3)] * 4 + [(3, 0, 3)] * 4
    lay, blk = ss.layouts[4], ss.states[4]        # north row, lon seam
    assert blk.u.shape == (8, 3 + 8, 8 + 6)
    cols = [(x - 3) % 32 for x in range(14)]
    np.testing.assert_array_equal(blk.u.numpy(),
                                  s.u[:, 5:16][:, :, cols].numpy())
    np.testing.assert_array_equal(ss.grids[4].lat.numpy(), g.lat[5:].numpy())
    np.testing.assert_array_equal(ss.grids[4].lon.numpy(),
                                  g.lon[cols].numpy())
    np.testing.assert_array_equal(ss.forcings[4].hsurf.numpy(),
                                  f.hsurf[5:16][:, cols].numpy())
    back = sharding.gather(ss)
    for name in FIELDS:
        assert torch.equal(getattr(back, name), getattr(s, name)), name


def test_ghost_width_is_the_chain_radius():
    """One ghost row fewer on the south side, or one ghost column fewer,
    changes the answer; one fewer on the north side does not (the chain
    reaches 3 rows south and 3 columns west, 2 rows north and 2 columns
    east: kernels/csrc/fused_substep.cu)."""
    cfg = dist_cfg(True, (2, 4), True)
    s, f, g = initialize(cfg, device="cpu")
    mesh = tmesh.make_mesh(cfg, device="cpu")
    run = make_packed_sharded_runner(cfg, N_STEPS)
    want = port_unsharded(True)

    def max_err(halo):
        out = sharding.gather(run(sharding.shard(mesh, s, g, f, halo), g))
        return max(float((getattr(out, n) - getattr(want, n)).abs().max())
                   for n in FIELDS)

    assert max_err(sharding.Halo()) < 1e-12
    assert max_err(sharding.Halo(north=2)) < 1e-12
    for halo in (sharding.Halo(south=2), sharding.Halo(cols=2),
                 sharding.Halo(2, 2, 2)):
        assert max_err(halo) > 1e-9, halo


def test_mesh_placement_rule():
    cfg = dist_cfg(True, (2, 4))
    mesh = tmesh.make_mesh(cfg, device="cpu")
    assert (mesh.rank, mesh.local_shards) == (None, list(range(8)))
    assert mesh.describe() == "8 shards on 1 device (cpu)"
    assert [mesh.index(s) for s in (0, 3, 4, 7)] == \
        [(0, 0), (0, 3), (1, 0), (1, 3)]
    assert mesh.shard(1, -1) == 7 and mesh.shard(0, 4) == 0
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.validate_divisibility(
            cfg.replace(grid=dataclasses.replace(cfg.grid, nx=30)), mesh)


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

SMALL = ["run", "--nx", "32", "--ny", "16", "--nz", "4", "--physics", "all",
         "--days", "0.02", "--dtype", "float64", "--device", "cpu"]


@pytest.mark.parametrize("mode", ["shard_map", "auto"])
def test_cli_run_sharded(capsys, mode):
    """``run`` on a 2x4 mesh in one process, both modes (the reference's
    ``test_cli_run_sharded``, without files): ``auto`` switches to
    ``shard_map`` with a note, and the run equals the unsharded one."""
    argv = SMALL + ["--backend", "pallas", "--mesh-lat", "2", "--mesh-lon",
                    "4", "--sharding-mode", mode, "--halo-overlap"]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert ("switching mode auto -> shard_map" in printed) == (mode == "auto")
    assert ("mesh=2x4 (shard_map, halo overlap, 8 shards on 1 device "
            "(cpu))") in printed
    args = cli.make_parser().parse_args(argv)
    res = cli.run(cli.build_config(args), device="cpu")
    want = cli.run(cli.build_config(cli.make_parser().parse_args(
        SMALL + ["--backend", "pallas"])), device="cpu")
    assert res.steps == want.steps and res.dts == want.dts
    for name in FIELDS:
        np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                   getattr(want.state, name).numpy(),
                                   err_msg=name, **SELF_TOL)


def test_cli_backend_and_mesh_flags(capsys):
    """``--backend jnp`` takes the plain path on any device; ``1x1``
    overrides a preset's mesh; a mesh with the plain backend is not
    ported."""
    assert cli.main(SMALL + ["--backend", "jnp"]) == 0
    assert "path=per-step (plain PyTorch dynamics, backend=jnp)" in \
        capsys.readouterr().out
    p = cli.make_parser()
    b4 = cli.build_config(p.parse_args(["run", "--baseline", "4"]))
    assert (b4.backend, b4.sharding.mesh_lat, b4.sharding.mesh_lon,
            b4.sharding.halo_overlap) == ("pallas", 2, 4, False)
    one = cli.build_config(p.parse_args(["run", "--baseline", "4",
                                         "--mesh-lat", "1", "--mesh-lon",
                                         "1", "--halo-overlap"]))
    assert (one.sharding.mesh_lat, one.sharding.mesh_lon) == (1, 1)
    assert one.sharding.halo_overlap and one.grid == b4.grid
    assert cli.describe_path(one) == \
        "packed scan (corrector with physics epilogue)"
    b1 = cli.build_config(p.parse_args(["run", "--baseline", "1"]))
    assert b1.backend == "jnp" and not tmodel.takes_packed_scan(b1)
    with pytest.raises(NotImplementedError, match="backend='jnp'"):
        cli.main(SMALL + ["--mesh-lon", "2", "--backend", "jnp"])
