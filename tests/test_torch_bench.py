"""The port's bench slice against the JAX package's (CPU).

* ``bench/roofline.py``: the byte model equals the reference's exactly;
  the card's peaks come from the card's name, and an unknown CUDA card
  raises.
* ``bench/budget.py``: the split-by-split budget record against the
  reference's on its own test's configuration (48x24x8, fp64,
  ``rad_every_steps=4``), then the reference's exact identities
  (``tests/integration/test_budget_identity.py``) on the port's record.
* ``bench/stability.py``: the per-chunk trajectory against the reference's.
* ``bench/throughput.py``, ``micro.py``, ``profile.py``, ``scaling.py``,
  ``opcount.py`` and the ``bench``/``profile`` subcommands: their keys and
  accounting on the CPU, where the kernels' plain versions run. Nothing
  here is a device metric.
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from climate_model_tpu.bench import budget as jbudget
from climate_model_tpu.bench import roofline as jroof
from climate_model_tpu.bench import stability as jstab
from climate_model_tpu.core import init as jinit
from climate_model_tpu_torch import cli
from climate_model_tpu_torch.bench import budget, micro, opcount, profile
from climate_model_tpu_torch.bench import roofline, scaling, stability
from climate_model_tpu_torch.bench import throughput
from climate_model_tpu_torch.core.config import (GridConfig, ModelConfig,
                                                 NumericsConfig,
                                                 PhysicsConfig,
                                                 ShardingConfig,
                                                 baseline_config,
                                                 default_diffusion,
                                                 resolve_rad_interval)
from climate_model_tpu_torch.core.init import initialize

from .test_torch_core import jax_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)


def small3(nx=16, ny=8, nz=4, **kw):
    """BASELINE #3's physics and numerics on a small grid."""
    return resolve_rad_interval(baseline_config(3).replace(
        grid=GridConfig(nx=nx, ny=ny, nz=nz), **kw))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stepper", ["euler", "matsuno", "rk4"])
def test_byte_model_equals_reference(stepper):
    for itemsize in (4, 8):
        for physics in (False, True):
            for every in (1, 6, 105):
                kw = dict(stepper=stepper, physics=physics,
                          rad_every_steps=every)
                assert roofline.step_bytes_per_point(32, itemsize, **kw) \
                    == jroof.step_bytes_per_point(32, itemsize, **kw)


def test_byte_model_monotonic():
    f = roofline.step_bytes_per_point
    assert f(32, 4, "euler") < f(32, 4, "matsuno") < f(32, 4, "rk4")
    assert f(32, 4, "matsuno", physics=True) > f(32, 4, "matsuno")
    assert f(32, 8, "matsuno") == 2 * f(32, 4, "matsuno")


@pytest.mark.parametrize("name,bw,fp32", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, 67e12),
    ("NVIDIA H100 PCIe", 2.0e12, 51e12),
    ("NVIDIA H100 NVL", 3.9e12, 60e12),
    ("cpu", 5.0e10, 1.0e12)])
def test_card_peaks(name, bw, fp32):
    assert roofline.peaks(name) == (bw, fp32)


def test_unknown_card_raises():
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        roofline.peaks("NVIDIA A100-SXM4-80GB")
    assert roofline.device_hbm_bw("cpu") == 5.0e10
    assert roofline.speed_of_light_gps("cpu", 32) > 0


def test_substep_bound_is_bytes_at_small_shape():
    st, fo, gr = initialize(small3(dtype="float64"), device="cpu")
    from climate_model_tpu_torch.kernels.fused_substep import predictor
    out = predictor(st, gr, fo, gr.dt, with_rad=True, with_diff=True)
    n_bytes, flops = roofline.substep_work(st, None, gr, fo, out)
    ms, by = roofline.substep_bound_ms(st, None, gr, fo, out)
    assert flops == roofline.FLOPS_PER_POINT * st.u.numel()
    assert by == "bytes" and ms == 1e3 * n_bytes / 5.0e10


# ---------------------------------------------------------------------------
# throughput and the CLI
# ---------------------------------------------------------------------------

KEYS = ("metric", "value", "unit", "vs_baseline", "step_time_ms", "device",
        "speed_of_light_gps", "vs_hbm_roofline")


@pytest.mark.parametrize("baseline,backend", [(1, "jnp"), (3, "jnp"),
                                              (3, "pallas")])
def test_throughput_harness_runs_small(monkeypatch, baseline, backend):
    orig = throughput.baseline_config
    monkeypatch.setattr(throughput, "baseline_config", lambda n: (
        resolve_rad_interval(orig(n).replace(grid=GridConfig(nx=16, ny=8,
                                                             nz=4)))))
    rec = throughput.run_benchmark(baseline=baseline, steps=3, repeats=2,
                                   backend=backend, device="cpu")
    for key in KEYS:
        assert key in rec
    assert rec["value"] > 0 and rec["device"] == "cpu"
    assert f"backend={backend}" in rec["metric"]
    assert ("vs_fp32_peak" in rec) == (backend == "pallas")


def test_cli_bench_prints_one_json_line():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--baseline", "1", "--steps", "3",
                       "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert rc == 0 and len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert all(k in rec for k in KEYS) and rec["value"] > 0


def test_cli_profile_runs(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["profile", "--nx", "16", "--ny", "8", "--nz", "4",
                       "--device", "cpu", "--trace-dir", str(tmp_path)])
    assert rc == 0
    out = buf.getvalue()
    for row in ("dynamics", "radiation_amortized", "surface", "turbulence",
                "microphysics", "total_per_step"):
        assert row in out, out
    assert os.path.exists(tmp_path / "trace.json")


def test_cli_bench_stability_and_halo_flag():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--stability", "--baseline", "1", "--steps",
                       "4", "--chunk", "2", "--device", "cpu"])
    rec = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 0 and rec["stable"] and rec["steps_run"] == 4
    assert "trajectory" not in rec and 0 < rec["max_wind"] < 100.0
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["bench", "--scaling", "--baseline", "1",
                         "--halo-overlap", "--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# micro, profile, scaling, opcount
# ---------------------------------------------------------------------------

def test_micro_bench_keys():
    rep = micro.micro_bench(baseline=1, iters=2, device="cpu")
    for key in ("config", "dtype", "device", "plan", "pred_ms", "corr_ms",
                "pred_bytes_floor_ms", "corr_bytes_floor_ms",
                "pred_vs_bytes", "corr_vs_bytes"):
        assert key in rep, key
    assert rep["config"] == "64x32x8" and "rad_ms" not in rep
    assert rep["plan"]["substep"]["grid"] == [2, 32]
    rep = micro.micro_bench(cfg=small3(), iters=2, device="cpu")
    assert rep["rad_every_steps"] > 1 and rep["step_model_ms"] > 0
    assert rep["pred_ms"] > 0 and rep["corr_ms"] > 0 and rep["rad_ms"] > 0


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_profile_rows(backend, tmp_path):
    rows = profile.profile_subsystems(small3(backend=backend),
                                      trace_dir=str(tmp_path), quiet=True,
                                      device="cpu")
    if backend == "pallas":
        want = ("predictor_kernel", "corrector_kernel(+physics epilogue)",
                "radiation", "radiation_amortized", "total_per_step")
    else:
        want = ("dynamics", "radiation", "radiation_amortized", "surface",
                "turbulence", "microphysics", "total_per_step", "trace_dir")
        assert os.path.exists(tmp_path / "trace.json")
    assert tuple(rows) == want
    assert rows["total_per_step"] > 0


def test_scaling_keys_and_jnp_refused():
    cfg = small3(nx=32, ny=16, sharding=ShardingConfig(
        mesh_lat=2, mesh_lon=2, halo_overlap=True))
    rec = scaling.measure_scaling(cfg, steps=2, device="cpu")
    for key in ("metric", "value", "unit", "vs_baseline", "gps_1dev",
                "gps_ndev", "gps_ratio", "n_devices"):
        assert key in rec
    assert rec["n_devices"] == 4 and rec["gps_1dev"] > 0 \
        and rec["gps_ndev"] > 0
    assert "4 shards on 1 device (cpu)" in rec["metric"]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        scaling.measure_scaling(cfg.replace(backend="jnp"), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        scaling.measure_scaling(cfg, mode="auto", device="cpu")


def test_opcount_audit_accounts():
    a = opcount.audit_substep(1, which="corrector", with_phys=True,
                              device="cpu")
    print(a.table())
    assert a.total_arith > 0 and a.total_moves > 0
    assert a.n_tiles == 64            # the launch plan's blocks at #1
    labeled = sum(v for k, v in a.region_elems.items()
                  if k != opcount.OUTSIDE)
    assert labeled >= 0.9 * a.total_arith, a.region_elems
    assert 0 <= a.redundant_elems <= a.total_arith
    assert "TOTAL" in a.table()
    p = opcount.audit_substep(1, which="predictor", device="cpu")
    c = opcount.audit_substep(1, which="corrector", with_phys=False,
                              device="cpu")
    assert abs(p.total_arith - c.total_arith) < 0.01 * c.total_arith


def test_opcount_counts_views_as_moves():
    counter = opcount._Counter()
    x = torch.ones(4, 6, dtype=torch.float64)
    with counter:
        y = x[1:].reshape(-1)
        z = torch.cat([y, y]) * 2.0 + 1.0
        w = y * 2.0
    assert sum(counter.arith.values()) == 2 * z.numel() + w.numel()
    assert sum(counter.moves.values()) >= y.numel() + z.numel()
    assert sum(counter.redundant.values()) == 0
    with counter:
        y * 2.0
    assert sum(counter.redundant.values()) == y.numel()


# ---------------------------------------------------------------------------
# budget and stability against the reference
# ---------------------------------------------------------------------------

def _budget_cfg(diff: float) -> ModelConfig:
    return ModelConfig(
        grid=GridConfig(nx=48, ny=24, nz=8),
        physics=PhysicsConfig(microphysics=True, radiation=True,
                              surface=True, turbulence=True,
                              rad_every_steps=4),
        numerics=NumericsConfig(diff_uv=diff, diff_pott=diff,
                                diff_moist=diff),
        dtype="float64")


def _port_budget(cfg, n_steps):
    state, forcing, grid = initialize(cfg, device="cpu")
    _, rec = budget.make_budget_scan(cfg, n_steps)(state, grid, forcing)
    area_tot = float(grid.area.sum()) * cfg.grid.nx
    return {k: v.numpy() for k, v in rec.items()}, grid.dt, area_tot


def test_budget_record_matches_reference():
    cfg = _budget_cfg(0.0)
    jc = jax_cfg(cfg)
    state, forcing, grid = jinit.initialize(jc)
    _, want = jax.jit(jbudget.make_budget_scan(jc, 10))(state, grid,
                                                        forcing)
    got, _, _ = _port_budget(cfg, 10)
    W, E = float(want["w_total"][-1]), float(want["e_total"][-1])
    for k in budget.REC_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (10,), k
        if k in ("w_total", "e_total"):
            np.testing.assert_allclose(got[k], w, rtol=1e-9, atol=0, err_msg=k)
        else:
            scale = W if k.startswith("w") else E
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-10 * scale, err_msg=k)


@pytest.fixture(scope="module")
def port_rec_diff0():
    return _port_budget(_budget_cfg(0.0), 30)


@pytest.fixture(scope="module")
def port_rec_diff():
    return _port_budget(_budget_cfg(default_diffusion(48)), 30)


def test_port_water_identities_exact(port_rec_diff0):
    rec, dt, _ = port_rec_diff0
    W = rec["w_total"][-1]
    evap = rec["w_srf_expect"]
    assert evap.min() > 0
    assert np.max(np.abs(rec["w_srf"] - evap)) < 1e-9 * np.max(evap)
    assert np.max(np.abs(rec["w_mic"])) < 1e-13 * W
    assert np.max(np.abs(rec["w_trb"])) < 1e-12 * W
    assert np.max(np.abs(rec["w_dyn"])) < 1e-4 * np.max(evap)


def test_port_water_leak_with_default_diffusion(port_rec_diff):
    rec, _, _ = port_rec_diff
    leak = rec["w_dyn"] + rec["w_trb"] + rec["w_mic"]
    assert abs(leak.sum()) < 0.01 * rec["w_srf_expect"].sum()


def test_port_energy_identities_exact(port_rec_diff0):
    rec, _, _ = port_rec_diff0
    E = rec["e_total"][-1]
    assert np.max(np.abs(rec["e_srf"] - rec["e_srf_expect"])) \
        < 1e-7 * np.max(np.abs(rec["e_srf"]))
    assert np.max(np.abs(rec["e_mic"])) < 1e-13 * E


def test_port_energy_residual_decomposition(port_rec_diff):
    rec, dt, area_tot = port_rec_diff
    to_wm2 = 1.0 / (area_tot * dt)
    adiabatic = (rec["e_dyn"] - rec["e_rad_applied"]) * to_wm2
    turb = rec["e_trb"] * to_wm2
    assert abs(adiabatic.mean()) < 5.0, adiabatic.mean()
    assert np.max(np.abs(adiabatic)) < 15.0
    assert np.max(np.abs(turb)) < 5.0


def test_stability_matches_reference():
    cfg = ModelConfig(grid=GridConfig(nx=32, ny=16, nz=4),
                      numerics=NumericsConfig(diff_uv=1e4, diff_pott=1e4,
                                              diff_moist=1e4),
                      dtype="float64")
    want = jstab.probe_stability(jax_cfg(cfg), steps=20, chunk=10,
                                 verbose=False)
    got = stability.probe_stability(cfg, steps=20, chunk=10, verbose=False,
                                    device="cpu")
    assert got["stable"] and got["steps_run"] == 20
    for key in ("metric", "steps_run", "steps_target", "blowup_step",
                "stable", "diff_uv", "diff_pott", "diff_moist", "grid"):
        assert got[key] == want[key], key
    assert got["dt"] == pytest.approx(want["dt"], rel=1e-12)
    assert len(got["trajectory"]) == len(want["trajectory"]) == 2
    for a, b in zip(got["trajectory"], want["trajectory"]):
        assert a["step"] == b["step"]
        for key in ("max_u", "max_v", "pott_min", "pott_max"):
            assert a[key] == pytest.approx(b[key], rel=1e-9), key
    low = stability.probe_stability(cfg, steps=20, chunk=10,
                                    wind_limit=0.1, verbose=False,
                                    device="cpu")
    assert low["blowup_step"] == 10 and not low["stable"]
    assert len(low["trajectory"]) == 1


def test_make_run_fn_is_the_chunk_runner():
    from climate_model_tpu_torch.model import make_chunk_runner, make_run_fn
    cfg = small3(dtype="float64")
    st, fo, gr = initialize(cfg, device="cpu")
    a = make_run_fn(cfg, 3)(st, gr, fo)
    b = make_chunk_runner(cfg, 3)(st, gr, fo)
    for f in ("u", "v", "pott", "qv", "qc", "colp", "tsurf", "rain"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.step == 3 and st.step == 0
