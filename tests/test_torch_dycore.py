"""The port's dycore operators, ``tendencies``, ``proceed`` and Matsuno step
against the JAX jnp operators and the NumPy oracle (CPU, fp64).

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


def test_unported_steppers_raise():
    cfg = small_cfg()
    for ts in ("euler", "rk4"):
        c = cfg.replace(numerics=cfg.numerics.__class__(time_stepping=ts))
        for backend in ("jnp", "pallas"):
            with pytest.raises(ValueError, match="not ported"):
                tstep.dynamics_step_fn(c.replace(backend=backend))
