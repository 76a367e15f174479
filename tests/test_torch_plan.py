"""The launch plan of the substep and physics-epilogue kernels
(``kernels/fused_substep.py::launch_plan``): for every level count the
kernels take and every block the port launches, each kernel's persistent
grid updates every column of the block in exactly one run, its runs are
balanced, its rings fit one block of the card and its halo counts stay
small; and shapes the kernels do not take are refused. The kernels compute
their layouts and runs from the same formulas; the card checks them
(``chip_smoke.py``, and the ``gpu`` test below).
"""

import numpy as np
import pytest
import torch

from climate_model_tpu_torch.core.config import GridConfig, ModelConfig
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.kernels import fused_substep as fs
from climate_model_tpu_torch.trace import counts

from ._torch_threads import torch_threads  # noqa: F401 (fixture)


LEVELS = (2, 8, 32, 64, 96, 128)
# (ny, nx) of the blocks the port launches: config #3's grid, #4's shard
# block and seam strip on its 2x4 mesh, and the 96-level check's grid;
# config #5's grid, and its shard blocks on its 4x8 mesh: a polar row's
# block is #4's 183x186 (180 + 3 ghost rows, 180 + 6 ghost columns), a
# middle row's has ghost rows on both sides (186x186); its seam strip is
# #4's 9x186
BLOCKS = ((180, 360), (183, 186), (9, 186), (32, 64), (720, 1440),
          (186, 186))
# the shard blocks and seam strips of #4 and #5 on 2x2, #4's on 1x4 and 4x1
MESH_BLOCKS = ((183, 366), (9, 366), (363, 726), (9, 726), (360, 186),
               (96, 720), (9, 720))


def substep_hits(ny, nx, sp):
    """How many runs of a marching plan (the substep's or the epilogue's)
    update each (row, column)."""
    starts = fs.strip_starts(nx, sp.tx)
    hits = np.zeros((ny, nx), dtype=np.int64)
    for segs in fs.substep_segments(ny, nx, sp.tx, sp.blocks):
        for s, j0, j1 in segs:
            hits[j0:j1, starts[s]:starts[s + 1]] += 1
    return hits


def run_weights(ny, nx, sp):
    """The weight of each block's run of a marching plan: its units' pass
    lanes."""
    starts = fs.strip_starts(nx, sp.tx)
    return [sum((j1 - j0) * fs.pass_lanes(starts[s + 1] - starts[s])
                for s, j0, j1 in segs)
            for segs in fs.substep_segments(ny, nx, sp.tx, sp.blocks)]


@pytest.mark.parametrize("ny,nx", BLOCKS + MESH_BLOCKS, ids=lambda v: str(v))
@pytest.mark.parametrize("nz", LEVELS)
def test_plan_covers_every_column_once(nz, ny, nx):
    plan = fs.launch_plan(nz, ny, nx)
    sp = plan.substep
    # the substep: strips of at most tx longitudes, widths equal to within
    # the 4 columns a copy moves, each column of the block in one run
    assert sp.tx in fs.STRIP_WIDTHS and 32 % sp.tx == 0
    starts = fs.strip_starts(nx, sp.tx)
    widths = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == nx and (widths >= 1).all()
    assert widths.max() <= sp.tx and widths.max() - widths.min() <= 4
    assert (substep_hits(ny, nx, sp) == 1).all(), sp
    assert sp.depth in fs.RING_DEPTHS
    assert sp.smem_bytes == 4 * fs.substep_smem_floats(nz, sp.tx, sp.depth)
    assert sp.smem_bytes <= fs.SMEM_LIMIT == 232_448, sp
    # the epilogue: the substep's rules with its own strip width and ring,
    # each column of the block in one run, no block without one
    ep = plan.epilogue
    assert ep.tx in fs.STRIP_WIDTHS and ep.depth in fs.EPILOGUE_DEPTHS
    assert (substep_hits(ny, nx, ep) == 1).all(), ep
    assert all(fs.substep_segments(ny, nx, ep.tx, ep.blocks))
    assert 1 <= ep.blocks <= fs.SMS * fs.BLOCKS_PER_SM
    assert ep.smem_bytes == 4 * fs.epilogue_smem_floats(nz, ep.tx, ep.depth)
    room = fs.SMEM_LIMIT - fs.EPILOGUE_STATIC_SMEM
    assert ep.smem_bytes <= room < fs.SMEM_LIMIT == 232_448, ep
    # the widest strip whose rings fit, then the deepest ring
    wider = [w for w in fs.STRIP_WIDTHS if w > ep.tx]
    assert all(4 * fs.epilogue_smem_floats(nz, w, d) > room
               for w in wider for d in fs.EPILOGUE_DEPTHS)
    assert ep.depth == max(d for d in fs.EPILOGUE_DEPTHS if 4 *
                           fs.epilogue_smem_floats(nz, ep.tx, d) <= room)
    # a physics task takes more columns where the runs are long
    units = (len(fs.strip_starts(nx, ep.tx)) - 1) * ny
    long_runs = units >= fs.LONG_RUN_ROWS * ep.blocks
    assert ep.phys_cols == (fs.LONG_RUN_PHYS_COLS if long_runs else 1)


@pytest.mark.parametrize("ny,nx", BLOCKS + MESH_BLOCKS, ids=lambda v: str(v))
def test_plan_runs_are_balanced(ny, nx):
    """Each persistent grid (the substep's at 32 levels, the epilogue's at
    every level count) is no larger than the card's SMs times blocks an SM
    (nor than its units); the runs' weights differ from the mean by less
    than one strip-row, a unit weighing its strip's pass lanes; a grid with
    as many blocks as units gives each block one."""
    plans = [fs.launch_plan(32, ny, nx).substep] + [
        fs.launch_plan(nz, ny, nx).epilogue for nz in LEVELS]
    for sp in plans:
        starts = fs.strip_starts(nx, sp.tx)
        units = (len(starts) - 1) * ny
        assert 1 <= sp.blocks <= min(fs.SMS * fs.BLOCKS_PER_SM, units)
        w = run_weights(ny, nx, sp)
        unit = max(fs.pass_lanes(e - s) for s, e in zip(starts, starts[1:]))
        mean = sum(w) / sp.blocks
        assert max(abs(x - mean) for x in w) < unit, (min(w), max(w), mean)
        if sp.blocks == units:
            assert all(sum(j1 - j0 for _, j0, j1 in segs) == 1 for segs in
                       fs.substep_segments(ny, nx, sp.tx, sp.blocks))


def test_plan_at_the_main_shapes():
    """Config #3, #4's shard block and #5 and its 4x8 middle block take
    strips of 32 longitudes at most and a ring of 6 rows, one block for
    each SM, in both kernels, the epilogue's long runs two columns a
    physics task; each halo count lies under the tiled plan it replaced
    (substep: 5/3 x 34/32 lines, 4/3 x 33/32 scans at #3; epilogue: 3/2 x
    33/32 profiles, its tiles of 2 rows); a 9-row seam strip takes a unit,
    one row of one strip, a block in both, and a column a physics task."""
    for ny, nx in ((180, 360), (183, 186), (720, 1440), (186, 186)):
        plan = fs.launch_plan(32, ny, nx)
        sp, ep = plan.substep, plan.epilogue
        assert (sp.tx, sp.depth, sp.blocks) == (32, 6, fs.SMS)
        assert sp.staged_rows_per_row < 5 / 3 * 34 / 32
        assert sp.scanned_cols_per_col < 4 / 3 * 33 / 32
        assert (ep.tx, ep.depth, ep.blocks) == (32, 6, fs.SMS)
        assert ep.phys_cols == fs.LONG_RUN_PHYS_COLS == 2
        assert ep.profiled_cols_per_col < 1.2 < 3 / 2 * 33 / 32
        assert ep.staged_rows_per_row < 1.05
    strip = fs.launch_plan(32, 9, 186)
    assert strip.substep.blocks == strip.epilogue.blocks == 6 * 9
    assert strip.epilogue.phys_cols == 1


def test_plan_at_baseline5_is_baseline3s():
    """Config #5 (16x #3's columns) takes #3's strip width, ring and shared
    memory and as many blocks; its 1440 longitudes fill 45 strips of 32
    exactly (#3's 360 take 12 of 28 and 32), so each of #5's runs is about
    245 rows against #3's 16, and its halo counts are lower. Both counts
    stay under 1.25 and 1.15 at both shapes. The epilogue's plan follows
    the same rules: #3's again at #5, its surface cores and profiles
    computed 1.06 times a column at most. Its largest index, of a 3-D
    field of 32x720x1440 = 33,177,600 cells, fits the kernels' 32-bit
    ``int`` point index (``csrc/fused_substep.cu``, ``point_update``)."""
    p3, p5 = fs.launch_plan(32, 180, 360), fs.launch_plan(32, 720, 1440)
    s3, s5 = p3.substep, p5.substep
    assert (s5.tx, s5.depth, s5.smem_bytes, s5.blocks) == (
        s3.tx, s3.depth, s3.smem_bytes, s3.blocks)
    assert set(np.diff(fs.strip_starts(1440, s5.tx))) == {32}
    assert set(np.diff(fs.strip_starts(360, s3.tx))) == {28, 32}
    rows5 = [sum(j1 - j0 for _, j0, j1 in segs)
             for segs in fs.substep_segments(720, 1440, s5.tx, s5.blocks)]
    assert min(rows5) >= 245 and max(rows5) <= 246
    for sp in (s3, s5):
        assert sp.staged_rows_per_row <= 1.25
        assert sp.scanned_cols_per_col <= 1.15
    assert s5.staged_rows_per_row < s3.staged_rows_per_row
    assert s5.scanned_cols_per_col < s3.scanned_cols_per_col
    e3, e5 = p3.epilogue, p5.epilogue
    assert (e5.tx, e5.depth, e5.smem_bytes, e5.blocks) == (
        e3.tx, e3.depth, e3.smem_bytes, e3.blocks)
    assert fs.substep_segments(720, 1440, e5.tx, e5.blocks) == \
        fs.substep_segments(720, 1440, s5.tx, s5.blocks)
    assert e5.profiled_cols_per_col <= 1.06 < e3.profiled_cols_per_col
    assert 32 * 720 * 1440 == 33_177_600 < 2**31 - 1


@pytest.mark.parametrize("ny,nx,staged,scanned", [
    (180, 360, 1.1852, 1.0907), (720, 1440, 1.0710, 1.0354)])
def test_plan_halo_counts(ny, nx, staged, scanned):
    """The counts at #3 and #5, from the segments: a segment of rows j0 ..
    j1-1 copies rows j0-1 .. j1 of its strip's columns and one around, and
    scans rows j0-1 .. j1-1 of its columns and one west."""
    sp = fs.launch_plan(32, ny, nx).substep
    assert sp.staged_rows_per_row == pytest.approx(staged, abs=1e-4)
    assert sp.scanned_cols_per_col == pytest.approx(scanned, abs=1e-4)


@pytest.mark.parametrize("ny,nx,profiled", [
    (180, 360, 1.0907), (720, 1440, 1.0354), (9, 186, 1.9498)])
def test_plan_epilogue_profile_counts(ny, nx, profiled):
    """The epilogue's ``profiled_cols_per_col`` at #3, #5 and #4's 9-row
    seam strip, against a count of the tasks its segments take: a segment
    of rows j0 .. j1-1 computes the surface cores and height profiles of
    rows j0-1 (where there is one) .. j1-1 of its columns and one west.
    The tiled kernel it replaced computed 1.55 at #3 and #5 (99 columns of
    a tile of 32 x 2) and 2.06 on the strip (66 of 32 x 1)."""
    ep = fs.launch_plan(32, ny, nx).epilogue
    assert ep.profiled_cols_per_col == pytest.approx(profiled, abs=1e-4)
    starts = fs.strip_starts(nx, ep.tx)
    # longitude i at index i + 1: a segment's columns i0 - 1 .. i1 - 1
    cores = np.zeros((ny, nx + 1), dtype=np.int64)
    for segs in fs.substep_segments(ny, nx, ep.tx, ep.blocks):
        for s, j0, j1 in segs:
            cores[max(j0 - 1, 0):j1, starts[s]:starts[s + 1] + 1] += 1
    assert (cores[:, 1:] >= 1).all()
    assert cores.sum() / (ny * nx) == pytest.approx(
        ep.profiled_cols_per_col, abs=1e-12)
    assert ep.profiled_cols_per_col < (1.55 if ny > 9 else 2.06)


@pytest.mark.parametrize("nz,ny,nx", [(1, 180, 360), (fs.MAX_NZ + 1, 9, 186),
                                      (32, 0, 360), (32, 180, 0)])
def test_plan_refuses_shapes_the_kernels_do_not_take(nz, ny, nx):
    with pytest.raises(ValueError):
        fs.launch_plan(nz, ny, nx)


def test_plan_is_computed_once_per_shape():
    fs.launch_plan.cache_clear()
    a = fs.launch_plan(32, 180, 360)
    assert fs.launch_plan(32, 180, 360) is a
    assert fs.launch_plan.cache_info().hits == 1


@pytest.mark.gpu
def test_wrapper_refuses_unplanned_shape_on_card():
    """A column of more levels than the kernels take raises before any
    launch (on the CPU the plain version takes it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU or interpret mode")
    cfg = ModelConfig(grid=GridConfig(nx=16, ny=8, nz=fs.MAX_NZ + 1),
                      dtype="float32")
    st, fo, gr = initialize(cfg, device=torch.device("cuda", 0))
    n0 = counts()["predictor"]
    with pytest.raises(ValueError, match="levels"):
        fs.predictor(st, gr, fo, gr.dt, with_rad=True, with_diff=True)
    assert counts()["predictor"] == n0
