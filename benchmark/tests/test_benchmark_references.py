"""The choice of the plain reference that judges a configuration
(``harness.reference_of``), and its working precision: on the CPU, at a
test's size."""

import dataclasses
import math

import pytest

from benchmark import check, control, harness

from ._small import small_cell

EULER = "tests.euler_reference"


def _set(cell, backend="jnp", dtype=None, time_stepping=None, cfl=None,
         reference=None):
    cell.namelist["backend"] = backend
    if dtype:
        cell.namelist["dtype"] = dtype
    num = cell.namelist["numerics"]
    if time_stepping:
        num["time_stepping"] = time_stepping
    if cfl:
        num["cfl"] = cfl
    if reference:
        cell.reference = reference
    return cell


def _run(cell, seed=4_000_000_011):
    return harness.execute(cell, seed, 3.0, False, device="cpu")


@pytest.mark.parametrize("wl", harness.manifest()["workloads"],
                         ids=lambda w: w["name"])
def test_the_cells_resolve_to_the_frozen_reference(wl):
    cell = harness.load_cell(wl["name"])
    assert cell.config in ("bl3", "bl5")
    ref = harness.reference_of(cell)
    assert ref.name == cell.reference == harness.REFERENCE == "reference"
    assert ref.model.__name__ == "benchmark.reference.model"
    assert ref.config.config_from_dict(cell.namelist).dtype == "float32"


def test_a_reference_is_a_package_path():
    cell = small_cell("bl3_run")
    cell.reference = "../reference"
    with pytest.raises(ValueError, match="dotted package path"):
        harness.reference_of(cell)


# Forward Euler at the cells' CFL number (0.7) blows up within two chunks
# of the small grid; at 0.15 it runs the window through.
EULER_CELL = dict(time_stepping="euler", cfl=0.15)


def test_euler_under_the_matsuno_reference_fails():
    res = _run(_set(small_cell("bl3_run"), **EULER_CELL))
    assert res["failed"] == 0 and res["correct"] is False
    over = [n for n, v, lim in res["checks"] if not v <= lim]
    assert over and set(over) <= set(check.COMPARED), res["checks"]


def test_euler_under_an_euler_reference_is_correct():
    cell = _set(small_cell("bl3_run"), reference=EULER, **EULER_CELL)
    assert harness.reference_of(cell).model.__name__ == \
        f"benchmark.{EULER}.model"
    res = _run(cell)
    assert res["correct"] is True, res["checks"]


def test_float64_is_judged_at_float64(monkeypatch):
    """The run at float64, and the same run judged by the reference at
    float32: every compared reading at float64 is at least 1000 times
    smaller; the control (the state held at float32) reads more than each
    reading at float64."""
    follow = check.follow
    at32 = {}

    def spy(ref, rcfg, snaps, arrays, call, device):
        assert rcfg.dtype == "float64"
        at32.update(follow(ref, dataclasses.replace(rcfg, dtype="float32"),
                           snaps, arrays, call, device))
        return follow(ref, rcfg, snaps, arrays, call, device)

    monkeypatch.setattr(check, "follow", spy)
    cell = _set(small_cell("bl3_run"), dtype="float64")
    res = _run(cell)
    assert res["failed"] == 0
    got = res["readings"]
    ctl = control.readings(cell, 4_000_000_101, "cpu")
    for f in check.COMPARED:
        assert math.isfinite(got[f]) and at32[f] > 0, f
        assert 1000 * got[f] <= at32[f], (f, got[f], at32[f])
        assert ctl[f] > got[f], (f, ctl[f], got[f])

