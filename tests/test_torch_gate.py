"""The whole model, kernel path against plain path (CPU, fp64): at a small
size, the comparison of the reference's on-device gate
(``tests/tpu/test_tpu_numerics.py::test_full_model_packed_matches_jnp_on_device``),
which ``chip_smoke.py`` phase 13 runs at full width on the card.

As the reference parametrises it: BASELINE #3's physics and numerics at its
hourly radiation cadence (7 steps at 32x16x8, as ``test_torch_model.py::
config3_small``), and #5's with radiation every 4 steps, each over 12
steps from the initial state, on one device. The port's
``backend='pallas'`` (the packed scan; on the CPU the kernel wrappers take
their plain versions) is held against the port's ``backend='jnp'`` (the
per-step path with the plain dynamics), and both against the JAX package's
``backend='jnp'`` ``make_chunk_runner``, at rtol 1e-9, atol 1e-10.
"""

import dataclasses

import numpy as np
import pytest

from climate_model_tpu import model as jmodel
from climate_model_tpu.core import init as jinit
from climate_model_tpu_torch import model as tmodel
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core import init as tinit
from climate_model_tpu_torch.trace import counts

from .test_torch_core import jax_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
          "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc")
TOL = dict(rtol=1e-9, atol=1e-10)
N_STEPS = 12


def gate_config(baseline: int):
    """The gate's config of ``baseline`` on a 32x16x8 grid, fp64, one
    device: #3 at its hourly cadence, #5 with radiation every 4 steps."""
    b = tcfg.baseline_config(baseline)
    cfg = b.replace(grid=dataclasses.replace(b.grid, nx=32, ny=16, nz=8),
                    dtype="float64",
                    sharding=dataclasses.replace(b.sharding, mesh_lat=1,
                                                 mesh_lon=1))
    if baseline == 5:
        cfg = cfg.replace(physics=dataclasses.replace(
            cfg.physics, rad_every_steps=4, rad_every_hours=0.0))
    return tcfg.resolve_rad_interval(cfg)


# the steps of the 12 at which radiation refreshes
REFRESHES = {3: (0, 7), 5: (0, 4, 8)}


def port_run(cfg):
    """``make_chunk_runner(cfg, N_STEPS)`` from the initial state, and the
    radiation refreshes it made."""
    s, f, g = tinit.initialize(cfg, device="cpu")
    r0 = counts()["radiation.refreshes"]
    out = tmodel.make_chunk_runner(cfg, N_STEPS)(s, g, f)
    assert out.step == N_STEPS
    return out, counts()["radiation.refreshes"] - r0


@pytest.mark.parametrize("baseline", [3, 5])
def test_kernel_path_matches_plain_path(baseline):
    cfg = gate_config(baseline)
    assert cfg.backend == "pallas" and tmodel.takes_packed_scan(cfg)
    every = cfg.physics.rad_every_steps
    assert every < N_STEPS
    assert tuple(k for k in range(N_STEPS) if k % every == 0) == \
        REFRESHES[baseline]
    plain_cfg = cfg.replace(backend="jnp")
    kern, n_kern = port_run(cfg)
    plain, n_plain = port_run(plain_cfg)
    assert n_kern == n_plain == len(REFRESHES[baseline])
    js, jf, jg = jinit.initialize(jax_cfg(plain_cfg))
    ref = jmodel.make_chunk_runner(jax_cfg(plain_cfg), N_STEPS)(js, jg, jf)
    assert int(ref.step) == N_STEPS
    for name in FIELDS:
        a, b = getattr(kern, name).numpy(), getattr(plain, name).numpy()
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, err_msg=f"{name}: pallas vs jnp",
                                   **TOL)
        np.testing.assert_allclose(a, r, err_msg=f"{name}: pallas vs the "
                                   "reference's jnp", **TOL)
        np.testing.assert_allclose(b, r, err_msg=f"{name}: jnp vs the "
                                   "reference's jnp", **TOL)


@pytest.mark.parametrize("baseline", [3, 5])
def test_gate_faults_show_at_small_size(baseline, monkeypatch):
    """The gate's two planted faults move the kernel path's answer: the
    radiation refresh after step 0 skipped leaves the caches stale, and
    the epilogue without the turbulence changes the prognostic fields.
    ``chip_smoke.py`` requires each to break a bound of its table on the
    card."""
    cfg = gate_config(baseline)
    sound, _ = port_run(cfg)
    real = tmodel.radiation_step
    monkeypatch.setattr(tmodel, "radiation_step",
                        lambda s, g, f, c: real(s, g, f, c) if s.step == 0
                        else s)
    stale, refreshes = port_run(cfg)
    assert refreshes == 1
    for name in ("dpottdt_rad", "swflx_sfc", "lwflx_sfc"):
        assert float((getattr(stale, name) - getattr(sound, name))
                     .abs().max()) > 1e-6, name
    monkeypatch.setattr(tmodel, "radiation_step", real)
    no_turb = tmodel.phys_epilogue_tuple(cfg.replace(
        physics=dataclasses.replace(cfg.physics, turbulence=False)))
    corr = tmodel.corrector
    monkeypatch.setattr(tmodel, "corrector",
                        lambda *a, phys, **k: corr(*a, phys=no_turb, **k))
    dry, _ = port_run(cfg)
    for name in ("u", "v", "pott", "qv"):
        assert float((getattr(dry, name) - getattr(sound, name))
                     .abs().max()) > 1e-6, name
