"""The port's physics (radiation, surface, turbulence, microphysics) against
the JAX reference on the same fp64 inputs (CPU).

Tolerance rtol=1e-11 with a small atol per field scale: both packages
evaluate the same elementwise expressions and sequential k-sweeps in fp64;
the only differences are libm rounding in exp/pow and summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_model_tpu.core.state import Forcing as JForcing
from climate_model_tpu.core.state import State as JState
from climate_model_tpu.core import grid as jgrid
from climate_model_tpu.physics import microphysics as jmic
from climate_model_tpu.physics import radiation as jrad
from climate_model_tpu.physics import surface as jsrf
from climate_model_tpu.physics import thermo as jthermo
from climate_model_tpu.physics import turbulence as jturb
from climate_model_tpu_torch.core.config import PhysicsConfig
from climate_model_tpu_torch.physics import microphysics as tmic
from climate_model_tpu_torch.physics import radiation as trad
from climate_model_tpu_torch.physics import surface as tsrf
from climate_model_tpu_torch.physics import thermo as tthermo
from climate_model_tpu_torch.physics import turbulence as tturb

from .test_torch_core import jax_cfg, jax_inputs, port_inputs, small_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

FULL = dict(microphysics=True, radiation=True, surface=True, turbulence=True)
FIELDS = ("u", "v", "pott", "qv", "qc", "tsurf", "rain", "soil_moist",
          "dpottdt_rad", "swflx_sfc", "lwflx_sfc")


def _setup(seed=0, t=0.0, step=0, saturate=False, **phys):
    cfg = small_cfg(physics=PhysicsConfig(**phys))
    st, fo, g = jax_inputs(cfg, seed=seed)
    r = np.random.default_rng(seed + 100)
    # moist, partly supersaturated air and a cloud stock, so condensation,
    # autoconversion and evaporation engage; ``saturate`` puts every layer
    # near saturation, so the moist-convective guard engages too
    if saturate:
        sig = g["sigma"][:, None, None]
        pair = g["ptop"] + sig * st["colp"][None]
        tair = st["pott"] * (pair / 1e5) ** (287.0 / 1004.0)
        st["qv"] = jthermo.qsat_water(tair, pair, np) \
            * r.uniform(0.96, 1.05, st["qv"].shape)
    else:
        st["qv"] = st["qv"] * r.uniform(0.8, 1.6, st["qv"].shape)
    st["qc"] = np.abs(r.normal(0, 3e-4, st["qc"].shape))
    st["tsurf"] = st["tsurf"] + r.normal(0, 15.0, st["tsurf"].shape)
    st["swflx_sfc"] = r.uniform(0, 300, st["tsurf"].shape)
    st["lwflx_sfc"] = r.uniform(-100, 0, st["tsurf"].shape)
    st["rain"] = r.uniform(0, 1, st["tsurf"].shape)
    st["t"] = np.asarray(t)
    st["step"] = np.asarray(step, np.int32)
    js = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    jf = JForcing(**{k: jnp.asarray(v) for k, v in fo.items()})
    jc = jax_cfg(cfg)
    jg = jgrid.make_grid(jc.grid, jc.numerics, dtype=jnp.float64)
    ts, tf, tg = port_inputs(st, fo, g)
    return cfg, jc, (js, jf, jg), (ts, tf, tg)


def _close(got, want, name, rtol=1e-11, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


def _states_close(a, b, names=FIELDS, atol=1e-12):
    for n in names:
        _close(getattr(b, n), getattr(a, n), n, atol=atol)


def test_thermo_match():
    r = np.random.default_rng(0)
    tair = r.uniform(200, 320, 50)
    pair = r.uniform(1e4, 1.05e5, 50)
    _close(tthermo.qsat_water(torch.tensor(tair), torch.tensor(pair)),
           jthermo.qsat_water(jnp.asarray(tair), jnp.asarray(pair)), "qsat")
    np.testing.assert_array_equal(tthermo.qsat_water(tair, pair, np),
                                  jthermo.qsat_water(tair, pair, np))


@pytest.mark.parametrize("t", [0.0, 43_200.0, 3.7e5])
def test_compute_radiation_match(t):
    cfg, jc, (js, jf, jg), (ts, tf, tg) = _setup(t=t, **FULL)
    a = jrad.compute_radiation(js, jg, jf, jc)
    b = trad.compute_radiation(ts, tg, tf, cfg)
    for name in a._fields:
        _close(getattr(b, name), getattr(a, name), name, atol=1e-10)


@pytest.mark.parametrize("step", [0, 3])
def test_radiation_step_refresh_and_hold(step):
    """Step 0 refreshes the cache, step 3 (rad_every_steps=6) holds it; the
    port counts the refreshes."""
    cfg, jc, (js, jf, jg), (ts, tf, tg) = _setup(step=step, **FULL)
    before = trad.radiation_step.refreshes
    a = jrad.radiation_step(js, jg, jf, jc)
    b = trad.radiation_step(ts, tg, tf, cfg)
    _states_close(a, b, ("dpottdt_rad", "swflx_sfc", "lwflx_sfc"), atol=1e-10)
    assert trad.radiation_step.refreshes - before == (1 if step == 0 else 0)


@pytest.mark.parametrize("soil", [True, False])
def test_surface_step_match(soil):
    cfg, jc, (js, jf, jg), (ts, tf, tg) = _setup(soil_moisture=soil, **FULL)
    fa = jsrf.surface_fluxes(js, jg, jf, jc)
    fb = tsrf.surface_fluxes(ts, tg, tf, cfg)
    for name in fa._fields:
        _close(getattr(fb, name), getattr(fa, name), name, atol=1e-10)
    a = jsrf.surface_step(js, jg, jf, jc, float(jg.dt))
    b = tsrf.surface_step(ts, tg, tf, cfg, tg.dt)
    _states_close(a, b, atol=1e-10)


@pytest.mark.parametrize("convection", [False, True])
def test_turbulence_step_match(convection):
    cfg, jc, (js, jf, jg), (ts, tf, tg) = _setup(
        convection=convection, saturate=convection, **FULL)
    if convection:
        from climate_model_tpu.dycore.operators import diagnose_pressure
        pvb, pvtf, _ = diagnose_pressure(js.colp, jg)
        ka = jturb.convective_k(js, pvb, pvtf, jc)
        from climate_model_tpu_torch.dycore.operators import \
            diagnose_pressure as tdp
        pb, pt, _ = tdp(ts.colp, tg)
        kb = tturb.convective_k(ts, pb, pt, cfg)
        np.testing.assert_array_equal(kb.numpy(), np.asarray(ka))
        assert float(kb.max()) > 0.0, "the convective guard never engaged"
    a = jturb.turbulence_step(js, jg, jf, jc, float(jg.dt))
    b = tturb.turbulence_step(ts, tg, tf, cfg, tg.dt)
    _states_close(a, b)


def test_microphysics_step_match():
    cfg, jc, (js, jf, jg), (ts, tf, tg) = _setup(**FULL)
    a = jmic.microphysics_step(js, jg, jf, jc, float(jg.dt))
    b = tmic.microphysics_step(ts, tg, tf, cfg, tg.dt)
    _states_close(a, b)
    assert float((b.rain - ts.rain).max()) > 0.0, "no rain formed"
