"""RK4 on the port's kernel path (CPU, fp64): the stage kernel's wrapper and
its plain version, the packed RK4 step that ``make_chunk_runner`` takes for
``backend='pallas'``, ``time_stepping='rk4'``, the compiled chunk's
bookkeeping for it, and the benchmark's plain RK4 reference.

BASELINE config #3's physics and numerics on a 32x16x8 grid, radiation
every 3 steps, from the initial state with its moisture raised near
saturation (so that the epilogue condenses and rains). On the CPU the
wrappers take their plain versions (``rk4_stage_plain``, a composition of
``tendencies`` and ``proceed``), so the packed step is held to the plain
``step_rk4`` with the plain physics splits (``make_step_fn`` on
``backend='jnp'``) at rtol = atol = 1e-12: the two differ only in the
order of the accumulator's sums.

The test marked ``gpu`` holds each stage kind against its plain version at
#3 on the card (``chip_smoke.py``'s phase 18 checks).
"""

import dataclasses

import pytest
import torch

from climate_model_tpu_torch import graphs, model, trace
from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.dycore import stepper as tstep
from climate_model_tpu_torch.dycore.operators import diagnose_pressure
from climate_model_tpu_torch.kernels import fused_substep as fs
from climate_model_tpu_torch.physics.thermo import qsat_water

from ._torch_threads import torch_threads  # noqa: F401 (fixture)
from .test_torch_graphs import StandInCapture

FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
          "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc")
TOL = dict(rtol=1e-12, atol=1e-12)
CHUNKS = (7, 5, 12)              # steps; the last chunk at 0.8 dt


def rk4_cfg(**physics):
    b3 = tcfg.baseline_config(3)
    return b3.replace(
        grid=dataclasses.replace(b3.grid, nx=32, ny=16, nz=8),
        physics=dataclasses.replace(b3.physics, rad_every_steps=3,
                                    rad_every_hours=0.0, **physics),
        numerics=dataclasses.replace(b3.numerics, time_stepping="rk4"),
        dtype="float64")


def moist_start(cfg):
    """The initial state with relative humidity 0.95-1.05 and cloud water
    of 1e-4 kg/kg, from a seeded generator."""
    s, f, g = initialize(cfg, device="cpu")
    gen = torch.Generator().manual_seed(7)
    pvb, pvtf, _ = diagnose_pressure(s.colp, g)
    qs = qsat_water(s.pott * pvtf, 0.5 * (pvb[:-1] + pvb[1:]))
    rh = 0.95 + 0.1 * torch.rand(qs.shape, generator=gen, dtype=qs.dtype)
    return s.replace(qv=qs * rh, qc=torch.full_like(qs, 1e-4)), f, g


def assert_close(a, b, fields=FIELDS):
    assert a.step == b.step
    torch.testing.assert_close(a.t, b.t, rtol=1e-14, atol=0)
    for f in fields:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), **TOL,
                                   msg=f)


@pytest.fixture(autouse=True)
def fresh_cache():
    graphs.clear_cache()
    saved = trace.counts()
    yield
    trace.reset_counts(saved)
    graphs.clear_cache()


# ---------------------------------------------------------------------------
# The packed RK4 step against the plain one
# ---------------------------------------------------------------------------

VARIANTS = {"full physics": {},
            "no split physics": dict(surface=False, turbulence=False,
                                     microphysics=False),
            "no radiation": dict(radiation=False)}


@pytest.mark.parametrize("physics", VARIANTS.values(), ids=VARIANTS.keys())
def test_packed_rk4_equals_plain_step_rk4(physics):
    cfg = rk4_cfg(**physics)
    s, f, g = moist_start(cfg)
    n = 8
    got = model.make_chunk_runner(cfg, n, graphs=False)(s, g, f)
    want = tstep.run_scan(model.make_step_fn(cfg.replace(backend="jnp")),
                          s, g, f, n)
    assert float(want.qc.abs().max()) > 0
    if cfg.physics.microphysics:
        assert float(want.rain.max()) > 0
    assert_close(got, want)


def test_per_step_path_takes_the_stages():
    """``dynamics_step_fn`` gives the stage kernels for ``'pallas'``: the
    per-step path with them equals the plain one."""
    cfg = rk4_cfg()
    s, f, g = moist_start(cfg)
    got = tstep.run_scan(model.make_step_fn(cfg), s, g, f, 4)
    want = tstep.run_scan(model.make_step_fn(cfg.replace(backend="jnp")),
                          s, g, f, 4)
    assert_close(got, want)


@pytest.mark.parametrize("mask", [False, True], ids=["index", "mask"])
def test_plain_stages_compose_step_rk4(mask):
    """The four plain stages, chained through one accumulator, are the
    dynamics of ``step_rk4``; stage 4 reads the accumulator and leaves
    it."""
    cfg = rk4_cfg()
    s, f, g = moist_start(cfg)
    vm = fs.wall_mask(g.ny, s.dtype, s.device) if mask else None
    acc = fs.rk4_accumulator(s)
    x = s
    for stage in (1, 2, 3, 4):
        before = {k: v.clone() for k, v in acc.items()}
        x = fs.rk4_stage(x, s, acc, g, f, g.dt, stage=stage, with_rad=True,
                         with_diff=True, vmask=vm)
    assert all(torch.equal(acc[k], before[k]) for k in acc)
    want = tstep.step_rk4(s, g, f, cfg)
    for name in ("u", "v", "colp", "pott", "qv", "qc"):
        torch.testing.assert_close(getattr(x, name), getattr(want, name),
                                   **TOL, msg=name)
    assert float(x.v[:, 0].abs().max()) == 0.0


FAULTS = {"k2 weighted 1 in place of 2": ("RK4_W", (1 / 6, 1 / 6, 1 / 3,
                                                    1 / 6)),
          "stage 2 advanced by dt in place of dt/2": ("RK4_C", (0.5, 1.0,
                                                                1.0))}


@pytest.mark.parametrize("fault", FAULTS.values(), ids=FAULTS.keys())
def test_planted_faults_break_the_comparison(monkeypatch, fault):
    cfg = rk4_cfg()
    s, f, g = moist_start(cfg)
    monkeypatch.setattr(fs, *fault)
    got = model.make_chunk_runner(cfg, 2, graphs=False)(s, g, f)
    want = tstep.run_scan(model.make_step_fn(cfg.replace(backend="jnp")),
                          s, g, f, 2)
    with pytest.raises(AssertionError):
        assert_close(got, want)


def test_stage_arguments_are_checked():
    cfg = rk4_cfg()
    s, f, g = moist_start(cfg)
    acc = fs.rk4_accumulator(s)
    kw = dict(with_rad=True, with_diff=True)
    with pytest.raises(ValueError, match="expected 1, 2, 3 or 4"):
        fs.rk4_stage(s, s, acc, g, f, g.dt, stage=5, **kw)
    del acc["qc"]
    with pytest.raises(TypeError, match="acc.qc"):
        fs.rk4_stage(s, s, acc, g, f, g.dt, stage=1, **kw)
    with pytest.raises(ValueError, match="out: expected"):
        fs.rk4_stage(s, s, fs.rk4_accumulator(s), g, f, g.dt, stage=1,
                     out={"u": s.u.clone()}, **kw)


def test_mesh_refuses_rk4_on_the_kernel_backend():
    cfg = rk4_cfg()
    mesh = cfg.replace(sharding=dataclasses.replace(cfg.sharding,
                                                    mesh_lat=2, mesh_lon=2))
    with pytest.raises(ValueError, match="rk4 on one device only"):
        model.make_chunk_runner(mesh, 2)
    model.make_chunk_runner(mesh.replace(backend="jnp"), 2)


# ---------------------------------------------------------------------------
# The compiled chunk's bookkeeping (a stand-in for the capture on the CPU)
# ---------------------------------------------------------------------------

def counting(monkeypatch):
    """Each call of the stage and epilogue wrappers from ``model`` moves
    the counter its launch would move on the card."""
    def stage(*a, stage, **k):
        trace.count(f"rk4_stage.k{stage}")
        return fs.rk4_stage(*a, stage=stage, **k)

    def epi(*a, **k):
        trace.count("epilogue")
        return fs.epilogue(*a, **k)

    monkeypatch.setattr(model, "rk4_stage", stage)
    monkeypatch.setattr(model, "epilogue", epi)


def counts() -> dict:
    """The launch and refresh counts that are not 0 (the plain physics
    splits' calls left out: the epilogue's plain version makes them on the
    CPU)."""
    return {k: v for k, v in trace.counts().items()
            if v and not k.endswith(".calls")}


def test_graph_runner_counts_and_equals_eager(monkeypatch):
    cfg = rk4_cfg()
    s, f, g = moist_start(cfg)
    counting(monkeypatch)
    out = {}
    for name, runner_for in (
            ("eager", lambda n: model.make_chunk_runner(cfg, n,
                                                        graphs=False)),
            ("graphs", lambda n: graphs.make_graph_runner(
                cfg, n, capture=StandInCapture))):
        trace.reset_counts()
        c0 = graphs.captures
        x = s
        for i, n in enumerate(CHUNKS):
            x = runner_for(n)(x, g.replace(dt=g.dt * (0.8 if i == 2
                                                       else 1.0)), f)
        out[name] = (x, counts(), graphs.captures - c0)
    (a, ca, _), (b, cb, caps) = out["eager"], out["graphs"]
    assert all(torch.equal(getattr(a, k), getattr(b, k))
               for k in FIELDS + ("t",))
    n = sum(CHUNKS)
    assert ca == cb == {**{f"rk4_stage.k{m}": n for m in (1, 2, 3, 4)},
                        "epilogue": n, "radiation.refreshes": 8}
    assert caps == 4
    (runner,) = graphs.cached_runners()
    work = runner.step_fn.launch["work"]
    assert len(work["stages"]) == 2 and set(work["acc"]) == set(
        fs.ACC_FIELDS)
    assert torch.equal(runner.sets[0][0]["u"], b.u)


# ---------------------------------------------------------------------------
# The benchmark's plain RK4 reference
# ---------------------------------------------------------------------------

def test_reference_rk4_equals_the_ports_plain_step():
    """``benchmark/reference_rk4`` (its frozen ``step_rk4`` over the frozen
    tendencies, radiation and splits) against the port's per-step path with
    the plain ``step_rk4``, in float64 over two radiation refreshes."""
    from benchmark import harness, inputs
    from benchmark.reference_rk4 import model as ref
    from benchmark.reference_rk4.config import config_from_dict
    from benchmark.tests._small import small_cell
    from climate_model_tpu_torch.core.namelist import config_from_dict as pc
    from climate_model_tpu_torch.io.convert import state_from_numpy

    cell = small_cell("bl3rk4_run")
    nl = harness.run_namelist(cell, 2)
    nl["dtype"] = "float64"
    pcfg, rcfg = pc(dict(nl)), config_from_dict(dict(nl))
    assert pcfg.numerics.time_stepping == rcfg.numerics.time_stepping \
        == "rk4"
    arrays = inputs.seeded_state(harness.reference_of(cell), rcfg, 78)
    _, pforcing, pgrid = initialize(pcfg, device="cpu")
    pstate = state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    pstep = model.make_step_fn(pcfg.replace(backend="jnp"))
    grid, forcing = ref.build(rcfg, "cpu", torch.float64)
    rstate = ref.make_state(arrays, arrays["t"], 0, "cpu", torch.float64)
    assert grid.dt == pgrid.dt
    n = 2 * rcfg.physics.rad_every_steps + 1
    for _ in range(n):
        pstate = pstep(pstate, pgrid, pforcing)
        rstate = ref.step(rstate, grid, forcing, rcfg)
    for f in ref.STATE_FIELDS:
        assert torch.equal(getattr(pstate, f), getattr(rstate, f)), f
    assert pstate.step == rstate.step == n


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_stage_kernels_against_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the RK4 stage kernel)")
    import chip_smoke as cs
    bad = []
    errs = cs.rk4_stage_checks(cs.check_inputs(torch.device("cuda", 0)),
                               bad)
    assert not bad, bad
    assert set(errs) == {"rk4_stage1", "rk4_stage2", "rk4_stage3",
                         "rk4_stage4", "rk4_epilogue", "rk4_step"}


def test_run_command_takes_the_rk4_kernel_path(capsys):
    """``run --stepper rk4`` on the kernel backend goes through
    ``cli.run``'s chunks on the packed RK4 step (the stage wrappers' plain
    versions on the CPU)."""
    from climate_model_tpu_torch import cli
    argv = ["run", "--device", "cpu", "--nx", "32", "--ny", "16", "--nz",
            "8", "--physics", "all", "--dtype", "float64", "--backend",
            "pallas", "--stepper", "rk4", "--days", "0.02",
            "--out-every-hours", "0.25"]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "packed scan (four RK4 stages, then the physics epilogue)" \
        in printed
    assert "done: " in printed
