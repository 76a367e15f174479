"""The port's dycore operators, ``tendencies``, ``proceed`` and its Matsuno,
Euler and RK4 steps against the JAX jnp operators and the NumPy oracle
(CPU, fp64), and the steppers' observed orders of convergence.

Tolerance rtol=atol=1e-11 against the jnp forms: the two packages evaluate
the same expressions in fp64 and differ only in summation order (cumsum/sum
over k). Against the oracle, which is written in another idiom, the bounds
are the reference's own oracle tests' (tests/unit/test_dycore_vs_oracle.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_model_tpu.core.state import Forcing as JForcing
from climate_model_tpu.core.state import State as JState
from climate_model_tpu.dycore import operators as jops
from climate_model_tpu.dycore import oracle_numpy as oracle
from climate_model_tpu.dycore import stepper as jstep
from climate_model_tpu.dycore import tendencies as jtnd
from climate_model_tpu.core import grid as jgrid
from climate_model_tpu_torch.dycore import boundaries as bc
from climate_model_tpu_torch.dycore import operators as tops
from climate_model_tpu_torch.dycore import stepper as tstep
from climate_model_tpu_torch.dycore import tendencies as ttnd

from .test_torch_core import jax_cfg, jax_inputs, port_inputs, small_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

TOL = dict(rtol=1e-11, atol=1e-11)
SIZES = [dict(nx=16, ny=10, nz=4), dict(nx=32, ny=16, nz=8)]


def _jax_objects(st, fo, g, cfg):
    state = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    forcing = JForcing(**{k: jnp.asarray(v) for k, v in fo.items()})
    grid = jgrid.make_grid(jax_cfg(cfg).grid, jax_cfg(cfg).numerics,
                           dtype=jnp.float64)
    return state, forcing, grid


def _setup(size, seed=0, **cfg_kw):
    cfg = small_cfg(**size, **cfg_kw)
    st, fo, g = jax_inputs(cfg, seed=seed)
    st["step"] = np.asarray(0, np.int32)
    js, jf, jg = _jax_objects(st, fo, g, cfg)
    ts, tf, tg = port_inputs(st, fo, g)
    return cfg, st, fo, (js, jf, jg), (ts, tf, tg)


def _close(got, want, name, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **tol)


def test_shifts():
    a = torch.arange(24, dtype=torch.float64).reshape(2, 3, 4)
    x = a.numpy()
    np.testing.assert_array_equal(bc.west(a).numpy(), np.roll(x, 1, -1))
    np.testing.assert_array_equal(bc.east(a).numpy(), np.roll(x, -1, -1))
    sz = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], 1)
    nz = np.concatenate([x[:, 1:], np.zeros_like(x[:, :1])], 1)
    sc = np.concatenate([x[:, :1], x[:, :-1]], 1)
    ncl = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    for f, want in [(bc.south_zero, sz), (bc.north_zero, nz),
                    (bc.south_clamp, sc), (bc.north_clamp, ncl)]:
        np.testing.assert_array_equal(f(a).numpy(), want)
    w = bc.enforce_v_walls(a)
    assert float(w[:, 0].abs().sum()) == 0.0 and float(a[:, 0].sum()) != 0.0


@pytest.mark.parametrize("size", SIZES)
def test_diagnostics_match(size):
    cfg, st, fo, (js, jf, jg), (ts, tf, tg) = _setup(size)
    dj = jops.diagnose(js.colp, js.pott, jf.hsurf, jg)
    dt_ = tops.diagnose(ts.colp, ts.pott, tf.hsurf, tg)
    g_np = jgrid.make_grid(jax_cfg(cfg).grid, jax_cfg(cfg).numerics,
                           np_mode=True)
    do = oracle.diagnose(st["colp"], st["pott"], fo["hsurf"], g_np)
    for name in dj._fields:
        _close(getattr(dt_, name), getattr(dj, name), name)
        _close(getattr(dt_, name), do[name], "oracle " + name,
               dict(rtol=1e-12, atol=1e-9))


@pytest.mark.parametrize("size", SIZES)
def test_continuity_match(size):
    cfg, st, fo, (js, jf, jg), (ts, tf, tg) = _setup(size)
    dt = tg.dt
    base = ts.colp * 1.0001
    cj = jops.continuity(js.u, js.v, js.colp, jnp.asarray(base.numpy()), dt, jg)
    ct = tops.continuity(ts.u, ts.v, ts.colp, base, dt, tg)
    for name in cj._fields:
        _close(getattr(ct, name), getattr(cj, name), name)


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_scalar_and_momentum_match(size, diff):
    cfg, st, fo, (js, jf, jg), (ts, tf, tg) = _setup(size)
    dt = tg.dt
    cj = jops.continuity(js.u, js.v, js.colp, js.colp, dt, jg)
    ct = tops.continuity(ts.u, ts.v, ts.colp, ts.colp, dt, tg)
    kj = jnp.full((jg.ny,), 4e4) if diff else None
    kt = torch.full((tg.ny,), 4e4, dtype=torch.float64) if diff else None
    for q in ("pott", "qv", "qc"):
        src_j = js.dpottdt_rad if q == "pott" else None
        src_t = ts.dpottdt_rad if q == "pott" else None
        a = jops.scalar_tendency(getattr(js, q), cj, js.colp, jg,
                                 source=src_j, diff_coef=kj)
        b = tops.scalar_tendency(getattr(ts, q), ct, ts.colp, tg,
                                 source=src_t, diff_coef=kt)
        _close(b, a, q)
    dj = jops.diagnose(js.colp, js.pott, jf.hsurf, jg)
    dt_ = tops.diagnose(ts.colp, ts.pott, tf.hsurf, tg)
    uj, vj = jops.momentum_tendency(js.u, js.v, js.pott, js.colp, cj, dj, jg,
                                    diff_coef=kj)
    ut, vt = tops.momentum_tendency(ts.u, ts.v, ts.pott, ts.colp, ct, dt_, tg,
                                    diff_coef=kt)
    _close(ut, uj, "dudt")
    _close(vt, vj, "dvdt")


@pytest.mark.parametrize("rad", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_tendencies_and_proceed_match(size, rad):
    """Full tendencies (with the radiative source and diffusion on) and the
    mass-weighted update, against the jnp forms and the oracle."""
    from climate_model_tpu_torch.core.config import (NumericsConfig,
                                                     PhysicsConfig)
    num = NumericsConfig(diff_uv=5e4, diff_pott=5e4, diff_moist=2e4)
    cfg, st, fo, (js, jf, jg), (ts, tf, tg) = _setup(
        size, numerics=num, physics=PhysicsConfig(radiation=rad))
    dt = tg.dt
    base = ts.replace(colp=ts.colp * 0.9999)
    tj = jtnd.tendencies(js, jnp.asarray(base.colp.numpy()), dt, jg, jf,
                         jax_cfg(cfg))
    tt = ttnd.tendencies(ts, base.colp, dt, tg, tf, cfg)
    for name in tj._fields:
        _close(getattr(tt, name), getattr(tj, name), name)
    pj = jtnd.proceed(js, tj, dt)
    pt = ttnd.proceed(ts, tt, dt)
    for name in ("u", "v", "pott", "qv", "qc", "colp"):
        _close(getattr(pt, name), getattr(pj, name), "proceed " + name)

    g_np = jgrid.make_grid(jax_cfg(cfg).grid, jax_cfg(cfg).numerics,
                           np_mode=True)
    to = oracle.tendencies(st, base.colp.numpy(), dt, g_np, fo["hsurf"],
                           dpottdt_src=st["dpottdt_rad"] if rad else None,
                           diff_uv=5e4, diff_pott=5e4, diff_moist=2e4)
    for name in ("dcolpdt", "dpottdt", "dqvdt", "dqcdt", "dudt", "dvdt"):
        _close(getattr(tt, name), to[name], "oracle " + name,
               dict(rtol=1e-10, atol=1e-8))


@pytest.mark.parametrize("size", SIZES)
def test_matsuno_steps_match(size):
    cfg, st, fo, (js, jf, jg), (ts, tf, tg) = _setup(size)
    jc = jax_cfg(cfg)
    g_np = jgrid.make_grid(jc.grid, jc.numerics, np_mode=True)
    a, b, o = js, ts, dict(st)
    for _ in range(3):
        a = jstep.step_matsuno(a, jg, jf, jc)
        b = tstep.step_matsuno(b, tg, tf, cfg)
        o = oracle.step_matsuno(o, float(g_np.dt), g_np, fo["hsurf"])
    for name in ("u", "v", "colp", "pott", "qv", "qc"):
        _close(getattr(b, name), getattr(a, name), name)
        _close(getattr(b, name), o[name], "oracle " + name,
               dict(rtol=1e-9, atol=1e-8))


@pytest.mark.parametrize("n_steps", [1, 8])
@pytest.mark.parametrize("stepper", ["euler", "rk4"])
def test_euler_rk4_steps_match(stepper, n_steps):
    """Euler and RK4 on the plain backend against the reference's
    ``step_euler`` / ``step_rk4``, at the Matsuno comparison's tolerance."""
    cfg, st, fo, (js, jf, jg), (ts, tf, tg) = _setup(SIZES[0])
    jc = jax_cfg(cfg)
    a, b = js, ts
    jfn = getattr(jstep, f"step_{stepper}")
    tfn = getattr(tstep, f"step_{stepper}")
    for _ in range(n_steps):
        a = jfn(a, jg, jf, jc)
        b = tfn(b, tg, tf, cfg)
    for name in ("u", "v", "colp", "pott", "qv", "qc"):
        _close(getattr(b, name), getattr(a, name), f"{stepper} {name}")


def _conv_run(cfg, stepper: str, dt: float, n_steps: int):
    import dataclasses
    from climate_model_tpu_torch.core.init import initialize
    c = cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, time_stepping=stepper, dt=dt))
    state, forcing, grid = initialize(c, device="cpu")
    return tstep.run_scan(tstep.dynamics_step_fn(c), state, grid, forcing,
                          n_steps)


def _conv_err(a, b):
    tot = 0.0
    for name in ("u", "v", "colp", "pott"):
        x, y = getattr(a, name).numpy(), getattr(b, name).numpy()
        tot += float(np.mean((x - y) ** 2) / (np.mean(y ** 2) + 1.0))
    return np.sqrt(tot)


@pytest.fixture(scope="module")
def conv_setup():
    """The reference's convergence setup (``tests/unit/
    test_stepper_convergence.py``) on the port: dry core, 32x16x4 fp64,
    horizon 8 CFL steps, error against RK4 at dt/16."""
    from climate_model_tpu_torch.core.config import NumericsConfig
    from climate_model_tpu_torch.core.grid import make_grid
    cfg = small_cfg(nx=32, ny=16, nz=4,
                    numerics=NumericsConfig(moisture_tendency=False))
    dt0 = float(make_grid(cfg.grid, cfg.numerics, dtype=torch.float64,
                          device="cpu").dt)
    n0 = 8
    return cfg, dt0, n0, _conv_run(cfg, "rk4", dt0 / 16.0, n0 * 16)


@pytest.mark.parametrize("stepper,levels,lo,hi", [
    ("euler", 3, 0.7, 1.4), ("matsuno", 3, 0.7, 1.6),
    ("rk4", 2, 3.5, float("inf"))])
def test_convergence_order(conv_setup, stepper, levels, lo, hi):
    """Observed temporal order on the port, with the reference's bounds
    (``tests/unit/test_stepper_convergence.py:63-83``)."""
    cfg, dt0, n0, ref = conv_setup
    errs = [_conv_err(_conv_run(cfg, stepper, dt0 / 2 ** k, n0 * 2 ** k),
                      ref) for k in range(levels)]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(levels - 1)]
    assert errs[0] > errs[-1] > 0.0
    assert lo < orders[-1] < hi, (orders, errs)


def test_pallas_steppers_raise():
    """Euler and RK4 run only on the plain backend, as in the reference:
    with ``backend='pallas'`` the port raises the reference's own error
    (``climate_model_tpu/dycore/stepper.py:145``), and an unknown stepper
    raises the reference's list of choices."""
    cfg = small_cfg()
    for ts in ("euler", "rk4"):
        c = cfg.replace(numerics=cfg.numerics.__class__(time_stepping=ts))
        tstep.dynamics_step_fn(c.replace(backend="jnp"))
        with pytest.raises(ValueError, match="supports matsuno only"):
            tstep.dynamics_step_fn(c.replace(backend="pallas"))
    c = cfg.replace(numerics=cfg.numerics.__class__(time_stepping="leap"))
    with pytest.raises(ValueError, match=r"unknown time_stepping 'leap'; "
                       r"choose from \['euler', 'matsuno', 'rk4'\]"):
        tstep.dynamics_step_fn(c.replace(backend="jnp"))
