"""Bytes and operations of the RK4 configuration's stage kernel and step:
the yardstick of ``metrics/roofline_pct.rk4_stage.py`` and
``metrics/step_mfu.rk4.py``. Read by no program code.

As ``benchmark/counts.py`` counts a Matsuno substep, a stage counts each
prognostic and forcing field that it needs once, read, and each output
once, written, from the grid's shape alone, at the width of the run
record's ``dtype``; the peaks and the least time are ``counts.py``'s.
"""

from __future__ import annotations

import re

from ..counts import (EPILOGUE_FLOPS_PER_POINT, FLOPS_PER_POINT,  # noqa: F401
                      least_s, peaks)

# the bytes of a value of each working precision a configuration may state
DTYPE_BYTES = {"float32": 4, "float64": 8}

# A stage's fields: (3-D read, 2-D read, 3-D written, 2-D written).
# Stage 1 reads the t_n state (u, v, pott, qv, qc) and the radiative
# heating, colp and the surface height, and writes the next stage state
# and the accumulator (u, v, pott, qv, qc and colp of each). Stages 2 and
# 3 also read the t_n state and the accumulator beside their own state.
# Stage 4 reads as they do and writes the step's state; the physics
# epilogue after it is counted with the step, fused, as the corrector's is.
STAGE_FIELDS = {
    1: (5 + 1, 2, 5 + 5, 1 + 1),
    2: (5 + 1 + 5 + 5, 1 + 1 + 1 + 1, 5 + 5, 1 + 1),
    3: (5 + 1 + 5 + 5, 1 + 1 + 1 + 1, 5 + 5, 1 + 1),
    4: (5 + 1 + 5 + 5, 1 + 1 + 1 + 1, 5, 1),
}

# Operations a point of a stage: the substep's (the tendencies and the
# update, ``counts.FLOPS_PER_POINT``) and the accumulator's w dt k, its sum
# and the increment c dt k of six conserved variables, rounded up.
STAGE_FLOPS_PER_POINT = FLOPS_PER_POINT + 20
STEP_FLOPS_PER_POINT = 4 * STAGE_FLOPS_PER_POINT + EPILOGUE_FLOPS_PER_POINT

# the stage kernel's launches by name in a device trace
KERNEL = re.compile(r"rk4_stage_kernel<(\d)>")


def dtype_bytes(dtype: str) -> int:
    return DTYPE_BYTES[dtype]


def stage_of(name: str):
    """The stage (1 to 4) of a device operation named ``name``, or None
    where it is no launch of the stage kernel."""
    m = KERNEL.search(name)
    return int(m.group(1)) if m and m.group(1) in "1234" else None


def stage_bytes(stage: int, nx: int, ny: int, nz: int,
                width: int = 4) -> float:
    r3, r2, w3, w2 = STAGE_FIELDS[stage]
    return float(width) * ((r3 + w3) * nz * ny * nx + (r2 + w2) * ny * nx)


def stage_flops(nx: int, ny: int, nz: int) -> float:
    return float(STAGE_FLOPS_PER_POINT) * nx * ny * nz


def step_bytes_per_point(rad_every_steps: int, width: int = 4) -> float:
    """Least memory traffic a grid point of one full-physics RK4 step: the
    85 traversals of the dynamics the four stages count (each stage's own
    state read, the t_n state and the accumulator read by stages 2-4, the
    next state and the accumulator written by 1-3, the step's state by 4),
    4 reads of the cached radiative heating, and the radiation's own 4
    traversals once every ``rad_every_steps`` steps."""
    dyn = sum(r3 + w3 for r3, _, w3, _ in STAGE_FIELDS.values()) - 4
    return (dyn + 4 + 4.0 / max(rad_every_steps, 1)) * width


def step_bytes(nx: int, ny: int, nz: int, rad_every_steps: int,
               width: int = 4) -> float:
    return step_bytes_per_point(rad_every_steps, width) * nx * ny * nz


def step_flops(nx: int, ny: int, nz: int) -> float:
    return float(STEP_FLOPS_PER_POINT) * nx * ny * nz
