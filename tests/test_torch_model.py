"""The slice as a whole: the port's two model paths against the JAX
reference's, and the port's ``run`` command (CPU, fp64).

BASELINE config #3's physics and numerics (full physics, hourly radiation,
scale-aware diffusion) on a 32x16x8 grid. The hour-based
radiation cadence resolves to 7 steps at this grid's dt, so 12 steps cross a
refresh. The packed scan (``make_chunk_runner``: predictor, then the
corrector with the physics epilogue) is held against the reference's default
``CLIMATE_TPU_PACKED_SCAN=1`` path, the per-step path (``run_scan`` of
``make_step_fn``) against its ``CLIMATE_TPU_PACKED_SCAN=0`` path; the
reference runs its Pallas kernel in interpret mode, the port's kernel
wrappers take the plain version on the CPU. Tolerance rtol=1e-9,
atol=1e-10, as in the reference's ``test_packed_full_model_matches_std``.
"""

import dataclasses
import functools
import math
import re

import numpy as np
import pytest
import torch

from climate_model_tpu import model as jmodel
from climate_model_tpu.core import init as jinit
from climate_model_tpu_torch import cli
from climate_model_tpu_torch import model as tmodel
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core import init as tinit
from climate_model_tpu_torch.core.grid import adaptive_cfl_dt
from climate_model_tpu_torch.dycore import stepper as tstep
from climate_model_tpu_torch.kernels import fused_substep as fs
from climate_model_tpu_torch.physics import radiation as trad

from .test_torch_core import jax_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
          "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc")


def config3_small():
    b3 = tcfg.baseline_config(3)
    return tcfg.resolve_rad_interval(b3.replace(
        grid=dataclasses.replace(b3.grid, nx=32, ny=16, nz=8),
        dtype="float64"))


def _reference_run(monkeypatch, packed: bool, cfg, n):
    monkeypatch.setenv("CLIMATE_TPU_PACKED_SCAN", "1" if packed else "0")
    js, jf, jg = jinit.initialize(jax_cfg(cfg))
    return jmodel.make_chunk_runner(jax_cfg(cfg), n)(js, jg, jf)


def _assert_matches_reference(out, ref, n):
    assert out.step == int(ref.step) == n
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-14)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)
    # on the CPU the kernel wrappers take the plain version and count nothing
    assert (fs.predictor.launches, fs.predictor.masked_launches,
            fs.corrector.launches, fs.corrector.masked_launches,
            fs.corrector.epilogue_launches) == (0, 0, 0, 0, 0)


def test_chunk_runner_matches_reference(monkeypatch):
    """The per-step path against the reference's per-step path."""
    cfg = config3_small()
    assert cfg.backend == "pallas" and cfg.physics.rad_every_steps == 7
    n = 12
    ref = _reference_run(monkeypatch, False, cfg, n)
    ts, tf, tg = tinit.initialize(cfg, device="cpu")
    refreshes = trad.radiation_step.refreshes
    out = tstep.run_scan(tmodel.make_step_fn(cfg), ts, tg, tf, n)
    assert trad.radiation_step.refreshes - refreshes == 2     # steps 0, 7
    _assert_matches_reference(out, ref, n)


def test_packed_scan_matches_reference(monkeypatch):
    """``make_chunk_runner`` takes the packed scan for config #3 and
    matches the reference's packed scan, the radiation caches included."""
    cfg = config3_small()
    assert tmodel.takes_packed_scan(cfg)
    n = 12
    ref = _reference_run(monkeypatch, True, cfg, n)
    ts, tf, tg = tinit.initialize(cfg, device="cpu")
    refreshes = trad.radiation_step.refreshes
    out = tmodel.make_chunk_runner(cfg, n)(ts, tg, tf)
    assert trad.radiation_step.refreshes - refreshes == 2     # steps 0, 7
    _assert_matches_reference(out, ref, n)


def test_packed_scan_equals_per_step_path():
    """The packed scan (the corrector's physics epilogue) and the per-step
    path (the physics splits after the dynamics) are one model."""
    cfg = config3_small()
    ts, tf, tg = tinit.initialize(cfg, device="cpu")
    a = tmodel.make_chunk_runner(cfg, 9)(ts, tg, tf)
    b = tstep.run_scan(tmodel.make_step_fn(cfg), ts, tg, tf, 9)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(),
                                   rtol=1e-12, atol=0, err_msg=name)


def test_packed_scan_chunk_boundaries():
    """Two 6-step chunks equal one 12-step chunk bit for bit (the reference's
    ``test_packed_scan_chunk_boundaries``)."""
    cfg = config3_small()
    ts, tf, tg = tinit.initialize(cfg, device="cpu")
    run6 = tmodel.make_chunk_runner(cfg, 6)
    a = run6(run6(ts, tg, tf), tg, tf)
    b = tmodel.make_chunk_runner(cfg, 12)(ts, tg, tf)
    assert a.step == b.step == 12
    for name in FIELDS + ("t",):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), err_msg=name)


def test_fused_path_equals_plain_path():
    """The per-step kernel path (substep wrappers) and the plain Matsuno
    step are the same model on the CPU."""
    cfg = config3_small()
    ts, tf, tg = tinit.initialize(cfg, device="cpu")
    a = tstep.run_scan(tmodel.make_step_fn(cfg), ts, tg, tf, 3)
    plain = tmodel.make_step_fn(cfg, dynamics=functools.partial(
        tstep.step_matsuno, cfg=cfg))
    b = tstep.run_scan(plain, ts, tg, tf, 3)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(),
                                   rtol=1e-12, atol=1e-13, err_msg=name)


def test_tendency_switches_stay_on_cpu():
    """The reference's backend rule: a config that turns a tendency off
    raises with ``backend='pallas'`` (the kernels carry every tendency), on
    any device and on both paths; with ``backend='jnp'`` it runs the plain
    step, as it would on the card, and matches the reference's jnp run."""
    cfg = config3_small()
    off = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                   wind_tendency=False))
    for build in (tstep.dynamics_step_fn, tmodel.make_step_fn,
                  lambda c: tmodel.make_chunk_runner(c, 1)):
        with pytest.raises(ValueError, match="requires all tendencies on"):
            build(off)
    plain = off.replace(backend="jnp")
    assert not tmodel.takes_packed_scan(plain)
    ts, tf, tg = tinit.initialize(plain, device="cpu")
    out = tmodel.make_chunk_runner(plain, 2)(ts, tg, tf)
    assert torch.isfinite(out.pott).all() and out.step == 2
    js, jf, jg = jinit.initialize(jax_cfg(plain))
    ref = jmodel.make_chunk_runner(jax_cfg(plain), 2)(js, jg, jf)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)


ARGV = ["run", "--nx", "32", "--ny", "16", "--nz", "8", "--physics", "all",
        "--adaptive-dt", "--diff", "1e5", "--days", "0.05",
        "--out-every-hours", "0.62", "--dtype", "float64", "--device",
        "cpu"]


def test_cli_run_adaptive_two_chunks(capsys):
    """``run`` with --adaptive-dt over two chunks: exit code 0, the exact
    horizon, dt re-evaluated per chunk through adaptive_cfl_dt, and the same
    final state as the chunk runner driven by hand with that dt."""
    assert cli.main(ARGV) == 0
    printed = capsys.readouterr().out
    assert printed.count("\nstep ") + printed.startswith("step ") == 2
    assert "done: " in printed

    cfg = cli.build_config(cli.make_parser().parse_args(ARGV))
    res = cli.run(cfg, device="cpu")
    assert len(res.chunks) == 2 and sum(res.chunks) == res.steps
    horizon = cfg.sim_days * 86400.0
    assert abs(float(res.state.t) - horizon) <= 0.5 * res.dts[-1]
    dt0 = res.dts[0]
    for rec, dt_next in zip(res.records[:-1], res.dts[1:]):
        want = max(adaptive_cfl_dt(res.min_dx, cfg.numerics.cfl,
                                   rec["max_wind"]), 0.05 * dt0)
        assert dt_next == pytest.approx(want, rel=1e-15)

    s, f, g = tinit.initialize(cfg, device="cpu")
    for n, dt in zip(res.chunks, res.dts):
        s = tmodel.make_chunk_runner(cfg, n)(s, g.replace(dt=dt), f)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(res.state, name).numpy(),
                                      getattr(s, name).numpy(), err_msg=name)
    assert all(math.isfinite(float(getattr(s, n).abs().max()))
               for n in FIELDS)


@pytest.mark.parametrize("argv,what", [
    (["run", "--mesh-lat", "2"], "backend='jnp'"),
    (["bench"], "bench"),
    (["profile"], "profile"),
])
def test_cli_unported_options_raise(argv, what):
    with pytest.raises(NotImplementedError, match=re.escape(what)):
        cli.main(argv + ["--device", "cpu"] if argv[0] == "run" else argv)


def test_cli_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--nx", "16", "--ny", "10", "--nz", "4"])
