"""The control comes out as not correct: the reference with its state held
in bfloat16 against the float32 reference, on three seeds, by the cell's
limits. At a test's size on the CPU; on the card at the cells' own sizes
(``python3 benchmark/control.py --workload NAME --seeds ...``)."""

import pytest

from benchmark import check, control, harness

from ._small import small_cell


@pytest.mark.parametrize("name", ["bl3_run", "bl5_run", "bl3_output"])
@pytest.mark.parametrize("seed", [4_000_000_101, 4_000_000_102,
                                  4_000_000_103])
def test_control_fails(name, seed):
    cell = small_cell(name)
    r = control.readings(cell, seed, "cpu")
    ok, lines = check.judge(r, {f: cell.limits[f] for f in check.COMPARED
                                if f in cell.limits})
    assert not ok, lines


@pytest.mark.gpu
def test_control_fails_at_full_size():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (full-size reference runs)")
    cell = harness.load_cell("bl3_run")
    r = control.readings(cell, 4_000_000_104, "cuda")
    ok, lines = check.judge(r, {f: cell.limits[f] for f in check.COMPARED
                                if f in cell.limits})
    assert not ok, lines
