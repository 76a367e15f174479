"""The fused substep's plain version (and its wrappers, which take the plain
version for CPU tensors) against the JAX reference's Pallas kernel run in
interpret mode, as ``tests/unit/test_pallas_substep.py`` runs it (CPU, fp64).

Tolerance rtol=atol=1e-10, as for the reference kernel against its own jnp
operators: both sides evaluate the same discrete equations in fp64, the
Pallas kernel in a re-associated order (halved flux factors, batched scans).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from climate_model_tpu.core import grid as jgrid
from climate_model_tpu.kernels.fused_substep import GEO_FIELDS as JGEO
from climate_model_tpu.kernels.fused_substep import make_fused_substep
from climate_model_tpu_torch.core.config import NumericsConfig
from climate_model_tpu_torch.kernels import fused_substep as fs

from .test_torch_core import jax_cfg, jax_inputs, port_inputs, small_cfg

TOL = dict(rtol=1e-10, atol=1e-10)
OUT = ("u", "v", "pott", "qv", "qc", "colp")


def _setup(nx, ny, nz, diff):
    num = NumericsConfig(diff_uv=5e4, diff_pott=5e4, diff_moist=2e4) \
        if diff else NumericsConfig()
    cfg = small_cfg(nx=nx, ny=ny, nz=nz, numerics=num)
    st, fo, g = jax_inputs(cfg, seed=nx + nz)
    st["step"] = np.asarray(0, np.int32)
    jc = jax_cfg(cfg)
    jg = jgrid.make_grid(jc.grid, jc.numerics, dtype=jnp.float64)
    return cfg, st, fo, jg, port_inputs(st, fo, g)


def _jax_kernel(jg, nz, ny, nx, same_base, with_rad, with_diff):
    return make_fused_substep(
        nz, ny, nx, bj=8 if ny >= 16 else 4, same_base=same_base,
        dt=float(jg.dt), dy=float(jg.dy), ptop=jg.ptop, with_rad=with_rad,
        with_diff=with_diff, dtype=jnp.float64, interpret=True,
        sigma_vb=np.asarray(jg.sigma_vb), dsigma=np.asarray(jg.dsigma))


def test_geo_fields_match_reference():
    assert fs.GEO_FIELDS == JGEO


@pytest.mark.parametrize("with_rad,with_diff", [(False, False),
                                                (True, True)])
@pytest.mark.parametrize("shape", [(16, 10, 4), (32, 16, 8)])
def test_plain_matches_pallas_interpret(shape, with_rad, with_diff):
    """Predictor, then corrector from the predicted state, through the
    port's wrappers (CPU: the plain version) and ``fused_substep_plain``
    directly, against the reference kernel on the same inputs."""
    nx, ny, nz = shape
    cfg, st, fo, jg, (ts, tf, tg) = _setup(nx, ny, nz, with_diff)
    dt = tg.dt
    geo = jnp.stack([getattr(jg, f) for f in JGEO], axis=1)
    hs = jnp.asarray(fo["hsurf"])
    rad = (jnp.asarray(st["dpottdt_rad"]),) if with_rad else ()
    fields = [jnp.asarray(st[f]) for f in OUT]
    kw = dict(with_rad=with_rad, with_diff=with_diff)

    pred_j = _jax_kernel(jg, nz, ny, nx, True, with_rad, with_diff)(
        *fields, hs, geo, *rad)
    pred_t = fs.predictor(ts, tg, tf, dt, **kw)
    pred_p = fs.fused_substep_plain(ts, None, tg, tf, dt, **kw)
    for name, want in zip(OUT, pred_j):
        np.testing.assert_allclose(getattr(pred_t, name).numpy(),
                                   np.asarray(want), err_msg=name, **TOL)
        np.testing.assert_array_equal(getattr(pred_t, name).numpy(),
                                      getattr(pred_p, name).numpy())

    # corrector: evaluate at the (port's) prediction, advance from t_n
    ev = [jnp.asarray(getattr(pred_t, f).numpy()) for f in OUT]
    corr_j = _jax_kernel(jg, nz, ny, nx, False, with_rad, with_diff)(
        *ev, hs, geo, *fields, *rad)
    corr_t = fs.corrector(pred_t, ts, tg, tf, dt, **kw)
    for name, want in zip(OUT, corr_j):
        np.testing.assert_allclose(getattr(corr_t, name).numpy(),
                                   np.asarray(want), err_msg=name, **TOL)
    assert pred_t.dpottdt_rad is ts.dpottdt_rad   # caches pass through


def test_runtime_dt():
    """dt is a runtime argument: the same wrapper serves any dt value and
    matches the reference kernel built for that dt."""
    nx, ny, nz = 16, 10, 4
    cfg, st, fo, jg, (ts, tf, tg) = _setup(nx, ny, nz, False)
    geo = jnp.stack([getattr(jg, f) for f in JGEO], axis=1)
    fields = [jnp.asarray(st[f]) for f in OUT]
    for scale in (1.0, 0.37):
        dt = tg.dt * scale
        ref = make_fused_substep(
            nz, ny, nx, bj=4, same_base=True, dt=dt, dy=float(jg.dy),
            ptop=jg.ptop, with_rad=False, dtype=jnp.float64, interpret=True)(
            *fields, jnp.asarray(fo["hsurf"]), geo)
        out = fs.predictor(ts, tg, tf, dt, with_rad=False, with_diff=False)
        for name, want in zip(OUT, ref):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(want), err_msg=name, **TOL)
