"""The launch plan of the substep and physics-epilogue kernels
(``kernels/fused_substep.py::launch_plan``): for every level count the
kernels take and every block the port launches, each kernel's tiles cover
every column of the block once, its shared memory fits one block of the
card, and shapes the kernels do not take are refused. The kernels compute
their tile layouts from the same formulas; the card checks them
(``chip_smoke.py``, and the ``gpu`` test below).
"""

import numpy as np
import pytest
import torch

from climate_model_tpu_torch.core.config import GridConfig, ModelConfig
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.kernels import fused_substep as fs

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
FLOATS = {"substep": fs.substep_smem_floats,
          "epilogue": fs.epilogue_smem_floats}


@pytest.mark.parametrize("ny,nx", BLOCKS, ids=lambda v: str(v))
@pytest.mark.parametrize("nz", LEVELS)
def test_plan_covers_every_column_once(nz, ny, nx):
    plan = fs.launch_plan(nz, ny, nx)
    for name, tile in (("substep", plan.substep),
                       ("epilogue", plan.epilogue)):
        assert tile.tx in fs.TILE_WIDTHS and 32 % tile.tx == 0, name
        assert tile.tj >= 1, name
        gx, gy = tile.grid
        hits = np.zeros((ny, nx), dtype=np.int64)
        for by in range(gy):
            for bx in range(gx):
                j0, i0 = by * tile.tj, bx * tile.tx
                # a block's own columns: its tile, cut at the block's edge
                hits[j0:min(j0 + tile.tj, ny), i0:min(i0 + tile.tx, nx)] += 1
        assert (hits == 1).all(), (name, tile)
        # no block of the grid is empty
        assert (gx - 1) * tile.tx < nx and (gy - 1) * tile.tj < ny, name
        assert tile.smem_bytes == 4 * FLOATS[name](nz, tile.tx, tile.tj)
        assert tile.smem_bytes <= fs.SMEM_LIMIT == 232_448, (name, tile)


def test_plan_at_the_main_shapes():
    """Config #3 and #4's shard block take 32-wide tiles of several rows;
    the epilogue's leave room for two blocks on an SM; a 9-row seam strip
    takes one row a tile, so its few columns spread over more blocks."""
    for ny, nx in ((180, 360), (183, 186), (720, 1440), (186, 186)):
        plan = fs.launch_plan(32, ny, nx)
        assert plan.substep.tx == plan.epilogue.tx == 32
        assert plan.substep.tj > 1 and plan.epilogue.tj > 1
        assert plan.epilogue.smem_bytes <= fs.SMEM_TWO_BLOCKS
    strip = fs.launch_plan(32, 9, 186)
    assert strip.substep.tj == strip.epilogue.tj == 1


def test_plan_at_baseline5_is_baseline3s():
    """Config #5 (16x #3's columns) takes #3's tiles and shared memory; its
    1440 longitudes fill 45 tiles of 32 exactly (#3's 360 need 12, the last
    a quarter full). Its largest index, of a 3-D field
    of 32x720x1440 = 33,177,600 cells, fits the kernels' 32-bit ``int``
    point index (``csrc/fused_substep.cu``, ``point_update``)."""
    p3, p5 = fs.launch_plan(32, 180, 360), fs.launch_plan(32, 720, 1440)
    for t3, t5 in ((p3.substep, p5.substep), (p3.epilogue, p5.epilogue)):
        assert (t5.tx, t5.tj, t5.smem_bytes) == (t3.tx, t3.tj, t3.smem_bytes)
        assert t5.grid[1] == 4 * t3.grid[1]
    assert p5.substep.grid == (45, 240) and p5.epilogue.grid == (45, 360)
    assert 32 * 720 * 1440 == 33_177_600 < 2**31 - 1


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
    n0 = fs.predictor.launches
    with pytest.raises(ValueError, match="levels"):
        fs.predictor(st, gr, fo, gr.dt, with_rad=True, with_diff=True)
    assert fs.predictor.launches == n0
