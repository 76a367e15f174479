"""The RK4 configuration's pieces: its plain reference passes the import
guard, its counts follow from the grid's shape and the dtype's width
alone, and its two readers (``roofline_pct.rk4_stage``, ``step_mfu.rk4``)
read a number on hand-made profiler events and nothing without a launch of
the stage kernel."""

import pytest

from benchmark import counts, harness, report, trace
from benchmark.reference_rk4 import counts as rk4

from .test_benchmark_trace import Ev

MS = 1_000_000
PEAKS = counts.peaks("NVIDIA H100 80GB HBM3")
SHAPE = (360, 180, 32)
KERNEL = "void (anonymous namespace)::rk4_stage_kernel<{}>(Args)"


def test_reference_passes_the_import_guard():
    cell = harness.load_cell("bl3rk4_run")
    assert cell.reference == "reference_rk4"
    assert harness.loaded_forbidden((), ("reference_rk4",)) == []
    names = harness.reference_imports("reference_rk4")
    assert "torch" in names
    assert not names & {*harness.FORBIDDEN, harness.PORT}
    ref = harness.reference_of(cell)
    assert ref.model.__name__ == "benchmark.reference_rk4.model"
    assert ref.config.config_from_dict(cell.namelist).numerics \
        .time_stepping == "rk4"


def test_counts_follow_the_shape_and_the_width():
    nx, ny, nz = SHAPE
    for stage in (1, 2, 3, 4):
        b4 = rk4.stage_bytes(stage, nx, ny, nz, 4)
        assert rk4.stage_bytes(stage, nx, ny, nz, 8) == 2 * b4
        assert rk4.stage_bytes(stage, 2 * nx, ny, nz, 4) == 2 * b4
        r3, r2, w3, w2 = rk4.STAGE_FIELDS[stage]
        assert b4 == 4 * ((r3 + w3) * nz * ny * nx + (r2 + w2) * ny * nx)
    # the four stages' 3-D traversals: 16 + 26 + 26 + 21, four of them
    # the radiative heating's reads
    assert sum(f[0] + f[2] for f in rk4.STAGE_FIELDS.values()) == 89
    assert rk4.step_bytes(nx, ny, nz, 105) == pytest.approx(
        (89 + 4 / 105) * 4 * nx * ny * nz)
    assert rk4.step_bytes(nx, ny, nz, 105, 8) == 2 * rk4.step_bytes(
        nx, ny, nz, 105)
    assert rk4.step_bytes(nx, ny, nz, 105) / counts.step_bytes(
        nx, ny, nz, 105) == pytest.approx(3.3, abs=0.05)
    assert rk4.step_flops(nx, ny, nz) == (4 * (counts.FLOPS_PER_POINT + 20)
                                          + 350) * nx * ny * nz
    assert rk4.dtype_bytes("float64") == 8 and rk4.dtype_bytes(
        "float32") == 4


def test_stage_of_kernel_names():
    assert [rk4.stage_of(KERNEL.format(m)) for m in (1, 2, 3, 4)] == \
        [1, 2, 3, 4]
    for name in ("void (anonymous namespace)::substep_kernel<true>(Args)",
                 "epilogue_kernel<1>", "rk4_stage_kernel<5>", "Memcpy"):
        assert rk4.stage_of(name) is None


def events(stage_ms=0.25, with_stages=True):
    """Two traced chunks of three steps: each step's four stage launches
    and an epilogue, each stage ``stage_ms`` long; the last launch of the
    window is cut in half by its end."""
    ev, t = [Ev("bench.runner", 0, 10)], 1 * MS
    for _ in range(2 * 3):
        for m in (1, 2, 3, 4):
            name = KERNEL.format(m) if with_stages \
                else "void (anonymous namespace)::substep_kernel<true>(Args)"
            ev.append(Ev(name, t, t + int(stage_ms * MS), cpu=False))
            t += int(stage_ms * MS)
        ev.append(Ev("epilogue_kernel<1>", t, t + MS // 5, cpu=False))
        t += MS // 5
    end = t - MS // 5 - int(stage_ms * MS) // 2
    ev.append(Ev("bench.trace_end", end, end + 10))
    return ev


def run_of(ev, dtype="float32"):
    rec = trace.records(ev, rank=0)
    return dict(grid=SHAPE, mesh=(1, 1), chips=1, peaks=PEAKS, dtype=dtype,
                rad_every_steps=105,
                ranks=[dict(rank=0, trace=rec,
                            traced_calls=[dict(n=3, dt=34.15)] * 2)])


def test_readers_read_hand_made_events():
    run = run_of(events())
    roof = report.reader("roofline_pct.rk4_stage")(run)
    w = trace.window(run["ranks"][0]["trace"])
    # every launch reads its own least time over its own time; the cut
    # launch counts half of each
    want = sum(counts.least_s(rk4.stage_bytes(m, *SHAPE),
                              rk4.stage_flops(*SHAPE), PEAKS)
               for m in (1, 2, 3, 4)) * 6 - 0.5 * counts.least_s(
        rk4.stage_bytes(4, *SHAPE), rk4.stage_flops(*SHAPE), PEAKS)
    assert roof == pytest.approx(100 * want / (24 * 0.25e-3 - 0.125e-3))
    assert 0 < roof < 100
    mfu = report.reader("step_mfu.rk4")(run)
    least = counts.least_s(rk4.step_bytes(*SHAPE, 105),
                           rk4.step_flops(*SHAPE), PEAKS)
    assert mfu == pytest.approx(100 * least / ((w[1] - w[0]) / 1e9 / 6))
    assert 0 < mfu < 100
    # at float64 every byte counts twice; the time stays
    assert report.reader("step_mfu.rk4")(run_of(events(), "float64")) \
        == pytest.approx(2 * mfu, rel=1e-3)


def test_readers_read_nothing_without_stage_launches():
    run = run_of(events(with_stages=False))
    assert report.reader("roofline_pct.rk4_stage")(run) is None
    assert report.reader("step_mfu.rk4")(run) is None
    assert report.reader("roofline_pct.rk4_stage")(
        dict(run_of(events()), peaks=None)) is None


@pytest.mark.parametrize("seed", [4_000_000_101, 4_000_000_102,
                                  4_000_000_103])
def test_control_fails_under_the_rk4_reference(seed):
    """The control of ``bl3rk4_run`` at a test's size: the RK4 reference
    with its state held in bfloat16 fails the cell's limits."""
    from benchmark import check, control

    from ._small import small_cell
    cell = small_cell("bl3rk4_run")
    r = control.readings(cell, seed, "cpu")
    ok, lines = check.judge(r, {f: cell.limits[f] for f in check.COMPARED
                                if f in cell.limits})
    assert not ok, lines
