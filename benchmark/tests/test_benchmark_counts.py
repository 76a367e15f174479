"""The frozen counts: bytes and operations from the grid's shape alone."""

import pytest

from benchmark import counts


def test_step_bytes_at_baseline_3():
    # 25 + 2 + 4/105 traversals of 4 bytes over 360x180x32 points
    assert counts.step_bytes(360, 180, 32, 105) == pytest.approx(224.26e6,
                                                                 rel=1e-4)


def test_substeps_hold_the_step_traversals():
    nz, ny, nx = 32, 180, 360
    three = sum(counts.SUBSTEP_FIELDS[k][0] + counts.SUBSTEP_FIELDS[k][2]
                for k in ("predictor", "corrector"))
    assert three == 27            # the step's 25 + the two heating reads
    pred = counts.substep_bytes("predictor", nx, ny, nz)
    assert pred == 4 * (11 * nz * ny * nx + 3 * ny * nx)


def test_least_time_is_bytes_bound_at_h100():
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    b = counts.step_bytes(360, 180, 32, 105)
    f = counts.step_flops(360, 180, 32)
    assert counts.least_s(b, f, pk) == pytest.approx(b / 3.35e12)
    assert f / pk.fp32_flops < b / pk.bytes_per_s


def test_unknown_card_raises():
    with pytest.raises(ValueError, match="no peaks"):
        counts.peaks("NVIDIA A100-SXM4-40GB")
