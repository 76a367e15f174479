"""The plain backend on a device mesh (``dist/halo.py``) against the JAX
package's single-device run (CPU, fp64, every shard in one process).

The config is the reference's own (``tests/distributed/
test_sharded_equivalence.py``: 32x16x4, fp64, ``backend='jnp'``, radiation
every 2 steps when physics is on, 5 steps). Its tests hold the reference's
``shard_map`` and GSPMD ``auto`` runs within rtol=atol=1e-10 of its
single-device run on meshes (1,8), (2,4) and (4,2); the port's per-operator
halo path and ``auto`` are held against that single-device run at the same
tolerance. The JAX runs are made once per setting and test session (as in
``test_torch_dist.py``), on one device: no 8-device JAX work is added.

Then the machinery itself: every shift primitive under shard mode equals
the global shift bit for bit on every mesh shape; a shard thread that
raises ends the run with its error at once; shards that leave lockstep are
refused, naming both shifts; a rendezvous that waits too long raises.
"""

import fcntl
import functools
import os
import time

import jax
import numpy as np
import pytest
import torch

from climate_model_tpu.core.init import initialize as jinitialize
from climate_model_tpu.dycore.stepper import run_scan as jrun_scan
from climate_model_tpu.model import make_step_fn as jmake_step_fn
from climate_model_tpu_torch import model as tmodel
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.dist import comm, halo, sharding
from climate_model_tpu_torch.dist.mesh import Mesh, make_mesh
from climate_model_tpu_torch.dycore import boundaries as bc

from .test_torch_core import jax_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

N_STEPS = 5
PROGS = ("u", "v", "colp", "pott", "qv", "qc")
TOL = dict(rtol=1e-10, atol=1e-10)
MESHES = [(1, 8), (2, 4), (4, 2)]


def halo_cfg(physics, mesh=(1, 1), mode="shard_map", stepper="matsuno"):
    phys = tcfg.PhysicsConfig(microphysics=physics, radiation=physics,
                              surface=physics, turbulence=physics,
                              rad_every_steps=2)
    return tcfg.ModelConfig(
        grid=tcfg.GridConfig(nx=32, ny=16, nz=4), physics=phys,
        numerics=tcfg.NumericsConfig(time_stepping=stepper),
        dtype="float64", backend="jnp",
        sharding=tcfg.ShardingConfig(mesh_lat=mesh[0], mesh_lon=mesh[1],
                                     mode=mode))


def reference_run(physics, stepper):
    """The JAX package's single-device ``run_scan(make_step_fn(cfg))``,
    N_STEPS from the initial state, as NumPy arrays."""
    cfg = jax_cfg(halo_cfg(physics, stepper=stepper))
    state, forcing, grid = jinitialize(cfg)
    step = jmake_step_fn(cfg)
    out = jax.block_until_ready(jax.jit(
        lambda s: jrun_scan(step, s, grid, forcing, N_STEPS))(state))
    return {f: np.asarray(getattr(out, f)) for f in PROGS}


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    """``reference(physics, stepper)``: ``reference_run``, computed once per
    test session (under xdist by the first worker that needs it, holding a
    lock in the directory that all workers share)."""
    shared = os.environ.get("PYTEST_XDIST_WORKER") is not None
    root = tmp_path_factory.getbasetemp()
    if shared:
        root = root.parent

    @functools.lru_cache(maxsize=None)
    def get(physics, stepper="matsuno"):
        path = root / f"torch_halo_reference_{int(physics)}_{stepper}.npz"
        with open(f"{path}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                np.savez(path, **reference_run(physics, stepper))
        with np.load(path) as z:
            return {f: z[f] for f in PROGS}

    return get


def port_run(physics, mesh, mode="shard_map", stepper="matsuno"):
    """The port's run through ``make_chunk_runner`` (a global State in,
    split over an in-process mesh and gathered back where the mode runs
    blocks)."""
    cfg = halo_cfg(physics, mesh, mode, stepper)
    s, f, g = initialize(cfg, device="cpu")
    out = tmodel.make_chunk_runner(cfg, N_STEPS)(s, g, f)
    assert out.step == N_STEPS
    return out


def check(out, ref, what):
    for name in PROGS:
        np.testing.assert_allclose(getattr(out, name).numpy(), ref[name],
                                   err_msg=f"{name} {what}", **TOL)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("physics", [False, True])
def test_shard_map_matches_single_device(reference, mesh_shape, physics):
    check(port_run(physics, mesh_shape), reference(physics),
          f"mesh={mesh_shape}")


@pytest.mark.parametrize("physics", [False, True])
def test_gspmd_auto_matches_single_device(reference, physics):
    """``auto`` in one process: the global program on the one device."""
    check(port_run(physics, (2, 4), mode="auto"), reference(physics),
          "auto 2x4")


@pytest.mark.parametrize("stepper", ["euler", "rk4"])
def test_steppers_on_mesh(reference, stepper):
    check(port_run(True, (2, 4), stepper=stepper),
          reference(True, stepper), f"{stepper} 2x4")


def test_shard_map_equals_unsharded_bitwise():
    """The shifts copy values, so on this CPU the sharded run equals the
    port's own unsharded run bit for bit, in every State field."""
    want = port_run(True, (1, 1))
    out = port_run(True, (2, 4))
    for name in sharding.STATE_FIELDS + ("t",):
        assert torch.equal(getattr(out, name), getattr(want, name)), name


def test_blocks_refuse_ghosts():
    cfg = halo_cfg(False, (2, 4))
    s, f, g = initialize(cfg, device="cpu")
    ss = sharding.shard(make_mesh(cfg, device="cpu"), s, g, f)   # ghosts
    with pytest.raises(ValueError, match="ghost-free"):
        tmodel.make_chunk_runner(cfg, 1)(ss, g, f)


# ---------------------------------------------------------------------------
# The shift primitives and the rendezvous
# ---------------------------------------------------------------------------

PRIMITIVES = ("west", "east", "south_zero", "north_zero", "south_clamp",
              "north_clamp", "enforce_v_walls")


def shards_of(mesh, x):
    """The ghost-free blocks of the global ``x``, shard order."""
    return [sharding.split(x, sharding.layout(mesh, s, x.shape[-2],
                                              x.shape[-1], halo.NO_HALO))
            for s in range(mesh.size)]


def run_shards(mesh, fn, blocks, timeout=comm.RENDEZVOUS_TIMEOUT_S):
    edges = comm.LocalEdges(mesh, timeout)
    return halo.in_lockstep(edges, fn, [(s, (b,))
                                        for s, b in enumerate(blocks)])


@pytest.mark.parametrize("name", PRIMITIVES)
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1), (2, 2), (1, 8),
                                        (2, 4), (4, 2), (8, 1)])
def test_shift_matches_global(mesh_shape, name):
    """Each primitive under shard mode, on random blocks, equals the
    global shift bit for bit: the lon ring (of 2 included), the lat chain
    (of 1 included) with its zero and clamped ends, the v wall on the
    southernmost shards only."""
    mesh = Mesh(*mesh_shape, torch.device("cpu"))
    r = np.random.default_rng(sum(mesh_shape) + len(name))
    x = torch.as_tensor(r.normal(size=(3, 16, 32)))
    fn = getattr(bc, name)
    got = run_shards(mesh, fn, shards_of(mesh, x))
    lays = [sharding.layout(mesh, s, 16, 32, halo.NO_HALO)
            for s in range(mesh.size)]
    assert torch.equal(sharding.assemble(got, lays), fn(x))


def test_failing_shard_ends_the_run():
    """A shard thread that raises ends the run with its error within a few
    seconds, though the timeout is long: the others stop at their next
    rendezvous. The pool's threads are free again afterwards."""
    mesh = Mesh(2, 4, torch.device("cpu"))

    def fn(a):
        for k in range(50):
            if k == 3 and bc._ctx().shard == 5:
                raise ZeroDivisionError("shard 5 failed")
            a = bc.west(bc.north_zero(a))
        return a

    x = torch.zeros(2, 16, 32)
    t0 = time.perf_counter()
    with pytest.raises(ZeroDivisionError, match="shard 5 failed"):
        run_shards(mesh, fn, shards_of(mesh, x), timeout=60.0)
    assert time.perf_counter() - t0 < 5.0
    # a thread left waiting would time this run out
    got = run_shards(mesh, bc.east, shards_of(mesh, x), timeout=10.0)
    assert len(got) == 8


def test_divergent_shifts_refused():
    """A shard whose shift differs from the others' (another primitive, or
    the run's end) is refused, naming both."""
    mesh = Mesh(2, 4, torch.device("cpu"))
    x = torch.zeros(2, 16, 32)

    def other_op(a):
        a = bc.west(a)
        return bc.east(a) if bc._ctx().shard == 6 else bc.west(a)

    with pytest.raises(comm.LockstepError,
                       match=r"rendezvous 1: .*(east|west) on \(2, 8, 8\), "
                             r"shard 0 runs (east|west)"):
        run_shards(mesh, other_op, shards_of(mesh, x), timeout=60.0)

    def ends_early(a):
        return a if bc._ctx().shard == 2 else bc.south_clamp(a)

    with pytest.raises(comm.LockstepError, match="end of run"):
        run_shards(mesh, ends_early, shards_of(mesh, x), timeout=60.0)


def test_rendezvous_times_out():
    mesh = Mesh(1, 2, torch.device("cpu"))

    def slow(a):
        if bc._ctx().shard == 1:
            time.sleep(1.0)
        return bc.west(a)

    with pytest.raises(TimeoutError, match="waited more than 0.2 s"):
        run_shards(mesh, slow, shards_of(mesh, torch.zeros(2, 4, 8)),
                   timeout=0.2)
