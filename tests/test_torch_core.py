"""The port's core (config, grid, initial state, conversion) against the JAX
reference, on the CPU in fp64.

Inputs cross between the packages as dicts of NumPy arrays
(``climate_model_tpu_torch/io/convert.py``). Config and grid must agree
exactly and the initial fields bitwise: both packages build them with the
same float64 NumPy expressions and cast once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_model_tpu.core import config as jcfg
from climate_model_tpu.core import grid as jgrid
from climate_model_tpu.core import init as jinit
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core import grid as tgrid
from climate_model_tpu_torch.core import init as tinit
from climate_model_tpu_torch.io import convert


def to_numpy(obj) -> dict:
    """Dict of NumPy arrays from a dataclass of either package (what the
    conversion functions take)."""
    out = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        out[f.name] = np.asarray(x)
    return out


def jax_inputs(cfg_port, seed=0, perturb=True):
    """Initial state, forcing and grid of ``cfg_port`` (a port config; the
    reference's is built from the same fields) as NumPy dicts, with the
    winds, POTT and moisture perturbed from a seeded generator so that the
    tendencies are not trivial."""
    cfg = jax_cfg(cfg_port)
    st, fo, _ = jinit.initialize(cfg)
    g = jgrid.make_grid(cfg.grid, cfg.numerics, dtype=jnp.float64)
    st, fo, g = to_numpy(st), to_numpy(fo), to_numpy(g)
    if perturb:
        r = np.random.default_rng(seed)
        st["u"] = st["u"] + r.normal(0, 1.0, st["u"].shape)
        v = st["v"] + r.normal(0, 1.0, st["v"].shape)
        v[:, 0, :] = 0.0
        st["v"] = v
        st["pott"] = st["pott"] + r.normal(0, 1.0, st["pott"].shape)
        st["qv"] = np.abs(st["qv"] + r.normal(0, 1e-4, st["qv"].shape))
        st["qc"] = np.abs(r.normal(0, 1e-5, st["qc"].shape))
        st["dpottdt_rad"] = r.normal(0, 1e-5, st["pott"].shape)
    return st, fo, g


def jax_cfg(cfg_port):
    """The reference's ModelConfig with the same field values."""
    def conv(obj, mod):
        kw = {}
        for f in dataclasses.fields(obj):
            x = getattr(obj, f.name)
            if dataclasses.is_dataclass(x):
                x = conv(x, mod)
            kw[f.name] = x
        return getattr(mod, type(obj).__name__)(**kw)
    return conv(cfg_port, jcfg)


def port_inputs(st, fo, g):
    """The port's State, Forcing and Grid (fp64, CPU) from NumPy dicts."""
    kw = dict(device="cpu", dtype=torch.float64)
    return (convert.state_from_numpy(st, **kw),
            convert.forcing_from_numpy(fo, **kw),
            convert.grid_from_numpy(g, **kw))


def small_cfg(nx=32, ny=16, nz=8, **kw):
    return tcfg.ModelConfig(grid=tcfg.GridConfig(nx=nx, ny=ny, nz=nz),
                            dtype="float64", **kw)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_baseline_configs_equal(n):
    a, b = jcfg.baseline_config(n), tcfg.baseline_config(n)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for ca, cb in [(a, b), (a.grid, b.grid), (a.physics, b.physics),
                   (a.numerics, b.numerics), (a.sharding, b.sharding)]:
        assert [f.name for f in dataclasses.fields(ca)] \
            == [f.name for f in dataclasses.fields(cb)]


def test_config_helpers_equal():
    for nx in (64, 240, 360, 1440):
        assert jcfg.default_diffusion(nx) == tcfg.default_diffusion(nx)
    unresolved = tcfg.ModelConfig(physics=tcfg.PhysicsConfig(
        radiation=True, rad_every_hours=2.0))
    with pytest.raises(ValueError):
        tcfg.check_rad_resolved(unresolved)
    resolved = tcfg.resolve_rad_interval(unresolved)
    tcfg.check_rad_resolved(resolved)
    assert resolved.physics.rad_every_steps == jcfg.resolve_rad_interval(
        jax_cfg(unresolved)).physics.rad_every_steps


@pytest.mark.parametrize("gcfg", [
    dict(nx=32, ny=16, nz=8), dict(nx=360, ny=180, nz=32),
    dict(nx=48, ny=20, nz=6, sigma_stretch=1.7, lat0_deg=-70.0),
])
def test_make_grid_exact(gcfg):
    """Every grid field agrees to 0 ulp in fp64 (same NumPy expressions);
    ``dy``/``dt`` are host floats in the port."""
    num_kw = dict(diff_uv=3e4, diff_pott=2e4, diff_moist=1e4)
    a = jgrid.make_grid(jcfg.GridConfig(**gcfg), jcfg.NumericsConfig(**num_kw),
                        dtype=jnp.float64)
    b = tgrid.make_grid(tcfg.GridConfig(**gcfg), tcfg.NumericsConfig(**num_kw),
                        dtype=torch.float64, device="cpu")
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, torch.Tensor):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                          err_msg=f.name)
        else:
            assert float(y) == float(x), f.name


@pytest.mark.parametrize("wind", [0.0, 57.0, 143.5])
def test_adaptive_cfl_dt_equal(wind):
    assert tgrid.adaptive_cfl_dt(20262.5, 0.7, wind) \
        == jgrid.adaptive_cfl_dt(20262.5, 0.7, wind)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("topo", ["gaussian_mountain", "aquaplanet",
                                  "continents"])
def test_initialize_bitwise(topo, dtype):
    cfg = small_cfg(topo=topo).replace(dtype=dtype)
    sj, fj, gj = jinit.initialize(jax_cfg(cfg))
    st, fo, gr = tinit.initialize(cfg, device="cpu")
    for a, b in [(sj, st), (fj, fo)]:
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, torch.Tensor):
                assert y.dtype == getattr(torch, dtype), f.name
                np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                              err_msg=f.name)
            else:
                assert int(y) == int(x), f.name
    assert gr.dt == float(gj.dt) and gr.dy == float(gj.dy)


def test_initialize_refuses_missing_card_and_topo_file():
    cfg = small_cfg()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinit.initialize(cfg)            # the default device is cuda
    with pytest.raises(NotImplementedError, match="not ported"):
        tinit.initialize(cfg.replace(topo_file="elevation.nc"), device="cpu")


def test_convert_round_trip():
    st, fo, g = jax_inputs(small_cfg(), seed=3)
    st["step"] = np.asarray(7, np.int32)
    state, forcing, grid = port_inputs(st, fo, g)
    back = convert.state_to_numpy(state)
    assert set(back) == set(st)
    for k, v in st.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert state.step == 7
    for k, v in fo.items():
        np.testing.assert_array_equal(getattr(forcing, k).numpy(), v)
    assert (grid.nx, grid.ny, grid.nz, grid.ptop) == (32, 16, 8, 10_000.0)
