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
# block and seam strip on its 2x4 mesh, and the 96-level check's grid
BLOCKS = ((180, 360), (183, 186), (9, 186), (32, 64))
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
    for ny, nx in ((180, 360), (183, 186)):
        plan = fs.launch_plan(32, ny, nx)
        assert plan.substep.tx == plan.epilogue.tx == 32
        assert plan.substep.tj > 1 and plan.epilogue.tj > 1
        assert plan.epilogue.smem_bytes <= fs.SMEM_TWO_BLOCKS
    strip = fs.launch_plan(32, 9, 186)
    assert strip.substep.tj == strip.epilogue.tj == 1


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
