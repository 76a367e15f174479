"""The climate slice on the CPU: the gate functions of ``chip_smoke.py``
(phase 15) and the reference's long-run gates run on the port.

Always on (fp64 where a model runs, one PyTorch thread):
- ``closure_residuals`` over the port's ``io/metrics.py::diagnostics`` and
  over the JAX package's, of the same states: the closure gate's physics at
  32x16x8, radiation every 4 steps, 3 chunks of 8 steps from a seeded
  state, on ``backend='pallas'`` (the kernels' plain versions on the CPU)
  and ``'jnp'``; every record field and the water terms agree at rtol
  1e-9, the residuals at 1e-9 of the TOA flux;
- ``annual_figures`` of the reference's year over the continents
  (``out_clim_continents/metrics.jsonl``) reproduces its figures, and the
  closure gate passes on the reference's first 30 days;
- planted faults in copies of those records break the closure gate, and a
  monotone +0.5 K/day POTT series breaks ``equilibrium_verdict``;
- phase 15's band tables are well formed and hold the reference's own
  readings; the gates' configs are the reference tests' configs.

Opt-in, as the reference's own (``CLIMATE_TPU_RUN_CLIMATE=1``,
``CLIMATE_TPU_RUN_MILESTONE2=1``; minutes of CPU each): the closure,
equilibrium and fine-grid gates and milestone #2 run on the port at the
reference's sizes and thresholds.
"""

import copy
import dataclasses
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from climate_model_tpu.core import config as jcfg
from climate_model_tpu.core.grid import make_grid as jmake_grid
from climate_model_tpu.core.init import initial_state_np
from climate_model_tpu.core.state import Forcing as JForcing
from climate_model_tpu.core.state import State as JState
from climate_model_tpu.dycore import oracle_numpy as oracle
from climate_model_tpu.io.metrics import diagnostics as jdiagnostics
from climate_model_tpu_torch import model as tmodel
from climate_model_tpu_torch.bench.stability import probe_stability
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core.grid import make_grid
from climate_model_tpu_torch.core.init import initialize

from .test_torch_core import jax_cfg, jax_inputs, port_inputs, to_numpy

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]
REF_METRICS = ROOT / "out_clim_continents" / "metrics.jsonl"
TOL = dict(rtol=1e-9, atol=0.0)
CPU = torch.device("cpu")


def ref_records() -> list:
    with open(REF_METRICS) as f:
        return [json.loads(line) for line in f]


def ref_area() -> float:
    """The area of BASELINE #3's grid (the closure gate's ``area_tot``)."""
    b3 = tcfg.baseline_config(3)
    g = make_grid(b3.grid, b3.numerics, dtype=torch.float64, device="cpu")
    return cs.area_total(g, b3.grid.nx)


def small_closure_cfg(backend: str):
    """The closure gate's physics at 32x16x8, fp64."""
    cfg = cs.climate_config("closure", backend, dtype="float64")
    return cfg.replace(grid=dataclasses.replace(cfg.grid, nx=32, ny=16,
                                                nz=8))


def jax_diag(cfg):
    """``diag(state, grid, forcing, cfg)`` of ``chip_smoke.chunk_records``
    that evaluates the JAX package's diagnostics on the port's state."""
    jc = jax_cfg(cfg)
    jg = jmake_grid(jc.grid, jc.numerics, dtype=jnp.float64)

    def diag(state, grid, forcing, _cfg):
        js = JState(**{k: jnp.asarray(v)
                       for k, v in to_numpy(state).items()})
        jf = JForcing(**{k: jnp.asarray(v)
                         for k, v in to_numpy(forcing).items()})
        return jdiagnostics(js, jg, jf, jc)
    return diag


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_closure_residuals_match_reference_diagnostics(backend):
    cfg = small_closure_cfg(backend)
    st, fo, g = jax_inputs(cfg, seed=11)
    st["step"] = np.asarray(0, np.int32)
    state = port_inputs(st, fo, g)[0]
    chunks, steps = 3, 8
    port, end, grid, _ = cs.chunk_records(cfg, chunks, steps, CPU,
                                          state=state)
    ref, end2, _, _ = cs.chunk_records(cfg, chunks, steps, CPU, state=state,
                                       diag=jax_diag(cfg))
    assert end.step == end2.step == chunks * steps
    assert cs.bitwise_equal(end, end2, cs.STATE_FIELDS)
    area = cs.area_total(grid, cfg.grid.nx)
    a = cs.closure_residuals(port, area)
    b = cs.closure_residuals(ref, area)
    assert len(a["resid"]) == chunks
    # a residual is a difference of nearly equal energies over a chunk, in
    # which the two packages' fp64 sums differ in their last bits: it is
    # held at rtol 1e-9 of the flux scale it is measured against (the TOA
    # net SW, ~240 W/m2), each term it is made of at rtol 1e-9 below
    flux = max(abs(r["toa_net_sw"]) for r in port)
    np.testing.assert_allclose(a["resid"], b["resid"], rtol=0.0,
                               atol=TOL["rtol"] * flux)
    for k in ("mean", "dwater", "evap_int", "water_err"):
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
    assert a["dwater"] > 0.0 and a["evap_int"] > 0.0
    for f in cs.RECORD_FIELDS:
        np.testing.assert_allclose([r[f] for r in port], [r[f] for r in ref],
                                   err_msg=f, **TOL)


def test_annual_figures_reproduce_reference_year():
    recs = ref_records()
    assert len(recs) == 1565
    fig = cs.annual_figures(recs)
    assert round(fig["toa_mean"], 3) == 0.078
    assert round(fig["toa_std"], 3) == 3.976
    assert round(fig["pott_mean"], 3) == 312.868
    assert round(fig["rain_over_evap"], 3) == 1.020
    for k, v in cs.REF_YEAR.items():
        assert fig[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    assert round(fig["min_dt"], 2) == 27.58
    assert not cs.band_failures(fig, cs.YEAR_BANDS)


def test_closure_holds_on_reference_first_30_days():
    recs = [r for r in ref_records() if r["t_days"] <= 30.0]
    assert len(recs) == 120
    cl = cs.closure_residuals(recs, ref_area())
    assert round(cl["mean"], 2) == 1.02
    assert round(cl["max_abs"], 2) == 6.43
    assert cl["water_err"] == pytest.approx(0.01006, abs=1e-5)
    assert cs.closure_failures(cl) == []


def _gate_records() -> list:
    """The reference's first records, as many as the closure gate's."""
    return copy.deepcopy(ref_records()[:cs.CLOSURE_RUN[0] + 1])


@pytest.mark.parametrize("fault,field,value,broken", [
    ("one chunk's evaporation doubled", "evap_rate", 2.0, "water closure"),
    ("one jump of energy by 1e9 J/m2", "energy", 1e9, "energy closure"),
])
def test_closure_planted_faults(fault, field, value, broken):
    area = ref_area()
    recs = _gate_records()
    assert cs.closure_failures(cs.closure_residuals(recs, area)) == []
    mid = len(recs) // 2
    if field == "evap_rate":
        recs[mid][field] *= value
    else:
        for r in recs[mid:]:
            r[field] += value
    fails = cs.closure_failures(cs.closure_residuals(recs, area))
    assert fails and all(f.startswith(broken) or broken in f
                         for f in fails), (fault, fails)


def _equilibrium_series(pott_trend=0.0) -> list:
    """20 records 3 days apart whose readings pass the equilibrium gate:
    TOA imbalance decaying 15 -> 5 W/m2, POTT flat, rain at 0.9 of an
    evaporation of 3 kg/m2/day; POTT rising ``pott_trend`` K/day."""
    evap = 3.0 / 86400.0
    return [dict(t_days=3.0 * (i + 1),
                 toa_net_sw=240.0 + 5.0 + 10.0 * 0.8 ** i,
                 olr=240.0, mean_pott=300.0 + pott_trend * 3.0 * (i + 1),
                 total_rain=0.9 * 3.0 * 3.0 * (i + 1), evap_rate=evap)
            for i in range(20)]


def test_equilibrium_verdict_planted_pott_trend():
    rd, fails = cs.equilibrium_verdict(_equilibrium_series())
    assert fails == [], rd
    rd, fails = cs.equilibrium_verdict(_equilibrium_series(pott_trend=0.5))
    assert rd["dpott_dt"] == pytest.approx(0.5)
    assert len(fails) == 1 and fails[0].startswith("POTT trend"), fails


def test_phase15_band_tables_hold_reference_readings():
    recs = ref_records()
    first = recs[0]
    assert first["step"] == cs.CONT_FIRST_LINE["step"]
    for k, v in cs.CONT_FIRST_LINE.items():
        assert first[k] == v, k
        assert k == "step" or cs.CONT_FIRST_TOL[k] > 0.0, k
    assert set(cs.CONT_FIRST_TOL) == set(cs.CONT_FIRST_LINE) - {"step"}
    # the window is the reference's records with t_days in [20, 30]
    win = [r["step"] for r in recs if 20.0 <= r["t_days"] <= 30.0]
    assert (win[0], win[-1]) == cs.CONT_WINDOW_STEPS and len(win) == 40
    wf = cs.window_figures(recs, cs.CONT_WINDOW_STEPS)
    assert wf["records"] == 40
    assert set(cs.CONT_WINDOW_BANDS) <= set(wf)
    for k, (lo, hi) in cs.CONT_WINDOW_BANDS.items():
        assert lo < hi and lo <= wf[k] <= hi, k
    assert round(wf["mean_pott"], 3) == 311.535
    assert round(wf["toa_imbalance"], 3) == 4.230
    assert round(wf["rain_over_evap"], 3) == 0.941
    colp = [r["mean_colp"] for r in recs]
    assert cs.CONT_MEAN_COLP[0] < min(colp) <= max(colp) \
        < cs.CONT_MEAN_COLP[1]
    for k, (lo, hi) in cs.YEAR_BANDS.items():
        assert lo < cs.REF_YEAR[k] < hi, k
    # the short-run constants stay the gaussian mountain's
    assert (cs.MEAN_COLP, cs.POTT_RANGE, cs.MASS_DRIFT, cs.MAX_WIND) == (
        (90_000.0, 91_000.0), (280.0, 340.0), 1e-6, 100.0)


def test_window_figures_refuses_other_steps():
    recs = [r for r in ref_records() if r["step"] != cs.CONT_WINDOW_STEPS[1]]
    with pytest.raises(AssertionError, match="no record at step"):
        cs.window_figures(recs, cs.CONT_WINDOW_STEPS)


@pytest.mark.parametrize("gate", list(cs.CLIMATE_GATES))
def test_climate_configs_are_the_reference_tests(gate):
    """``climate_config`` builds test_climate_sanity.py's configs."""
    (nx, ny, nz), every, diff = cs.CLIMATE_GATES[gate]
    k = jcfg.default_diffusion(nx) if diff is None else diff
    want = jcfg.ModelConfig(
        grid=jcfg.GridConfig(nx=nx, ny=ny, nz=nz),
        physics=jcfg.PhysicsConfig(microphysics=True, radiation=True,
                                   surface=True, turbulence=True,
                                   rad_every_steps=every),
        numerics=jcfg.NumericsConfig(diff_uv=k, diff_pott=k, diff_moist=k),
        dtype="float32")
    assert jax_cfg(cs.climate_config(gate, backend="jnp")) == want
    assert cs.climate_config(gate).backend == "pallas"


def test_milestone2_checks_planted_fault():
    """The milestone-2 invariants hold on #2's initial state and each
    planted fault breaks its own."""
    cfg = tcfg.baseline_config(2).replace(
        grid=tcfg.GridConfig(nx=48, ny=24, nz=4))
    s0, _, g0 = initialize(cfg, device="cpu")
    assert all(ok for ok, _ in cs.milestone2_checks(s0, s0, g0))
    faults = {"POTT finite": s0.replace(pott=s0.pott * float("nan")),
              "max wind": s0.replace(u=s0.u + 200.0),
              "dry-mass drift": s0.replace(colp=s0.colp * 1.001),
              "least qv": s0.replace(qv=s0.qv - 1.0),
              "POTT [": s0.replace(pott=s0.pott + 200.0)}
    for name, bad in faults.items():
        broken = [what for ok, what in cs.milestone2_checks(s0, bad, g0)
                  if not ok]
        assert any(w.startswith(name) for w in broken), (name, broken)


# ---------------------------------------------------------------------------
# Opt-in: the reference's long-run gates on the port, at their sizes
# ---------------------------------------------------------------------------

_climate = pytest.mark.skipif(
    os.environ.get("CLIMATE_TPU_RUN_CLIMATE") != "1",
    reason="climate-sanity closure gates are opt-in "
           "(CLIMATE_TPU_RUN_CLIMATE=1; several minutes)")
_milestone2 = pytest.mark.skipif(
    os.environ.get("CLIMATE_TPU_RUN_MILESTONE2") != "1",
    reason="full-size milestone #2 is opt-in "
           "(CLIMATE_TPU_RUN_MILESTONE2=1; several minutes)")


@_climate
def test_energy_and_water_closure():
    cfg = cs.climate_config("closure", backend="jnp")
    recs, _, grid, _ = cs.chunk_records(cfg, *cs.CLOSURE_RUN, CPU)
    cl = cs.closure_residuals(recs, cs.area_total(grid, cfg.grid.nx))
    assert cs.closure_failures(cl) == [], cl


@_climate
def test_equilibrium_approach():
    cfg = cs.climate_config("equilibrium", backend="jnp")
    chunks, days = cs.EQUILIBRIUM_RUN
    _, _, g0 = initialize(cfg, device="cpu")
    steps = int(days * 86400.0 / float(g0.dt))
    recs, *_ = cs.chunk_records(cfg, chunks, steps, CPU)
    rd, fails = cs.equilibrium_verdict(recs[1:])
    assert fails == [], rd


@_climate
def test_fine_grid_stability_with_default_diffusion():
    cfg = cs.climate_config("fine grid", backend="jnp")
    steps, chunk, limit = cs.FINE_RUN
    out = probe_stability(cfg, steps=steps, chunk=chunk, wind_limit=limit,
                          verbose=False, device="cpu")
    assert out["stable"], out


@_milestone2
def test_milestone2_fullsize_500_steps():
    cfg = tcfg.baseline_config(2)
    assert (cfg.grid.nx, cfg.grid.ny, cfg.grid.nz) == (240, 120, 16)
    s0, f0, g0 = initialize(cfg, device="cpu")
    out = tmodel.make_run_fn(cfg, cs.M2_STEPS, donate=False)(s0, g0, f0)
    assert out.step == cs.M2_STEPS
    broken = [w for ok, w in cs.milestone2_checks(s0, out, g0) if not ok]
    assert not broken, broken


@_milestone2
def test_milestone2_fullsize_oracle_allclose():
    cfg = tcfg.baseline_config(2).replace(dtype="float64")
    st, fo, grid_np = initial_state_np(jax_cfg(cfg))
    state, forcing, grid = initialize(cfg, device="cpu")
    step = tmodel.make_step_fn(cfg)
    dt = float(grid_np.dt)
    assert dt == grid.dt
    p, num = cfg.physics, cfg.numerics
    s_np = dict(st)
    for _ in range(20):
        s_np = oracle.step_moist(s_np, dt, grid_np, fo["hsurf"],
                                 diff_uv=num.diff_uv,
                                 diff_pott=num.diff_pott,
                                 diff_moist=num.diff_moist,
                                 qc_autoconv_time=p.qc_autoconv_time,
                                 qc_autoconv_threshold=p.qc_autoconv_threshold)
        state = step(state, grid, forcing)
    for name in ("u", "v", "colp", "pott", "qv", "qc"):
        np.testing.assert_allclose(
            getattr(state, name).numpy(), s_np[name],
            rtol=1e-9, atol=1e-10, err_msg=name)


def test_climate_year_tool(tmp_path, capsys):
    """tools/climate_year.py passes the reference's own year and refuses a
    year with a record left out or cut short."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "climate_year", ROOT / "tools" / "climate_year.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main([str(REF_METRICS)]) == 0
    recs = ref_records()
    broken = {"reversed": recs[:100] + recs[101:99:-1] + recs[102:],
              "short": recs[:-10]}
    for name, rs in broken.items():
        path = tmp_path / f"{name}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in rs))
        assert tool.main([str(path)]) == 1, name
    out = capsys.readouterr().out
    assert "does not rise" in out and "ends at day" in out
