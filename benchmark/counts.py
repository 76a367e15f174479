"""Bytes, operations and peaks: the yardstick of the benchmark's roofline
shares. Read by no program code.

Frozen copy of ``climate_model_tpu_torch/bench/roofline.py`` at commit
dbbffa0: ``PEAKS`` (NVIDIA's data sheets; an unknown card raises),
``step_bytes_per_point`` (the field traversals a step needs under perfect
fusion, whatever implements the step) and ``FLOPS_PER_POINT`` (a labelled
upper estimate of a substep's operations; the epilogue's as much again).
The substep counts are new here: they count each prognostic and forcing
field that a substep needs, read once, and each output, written once, from
the grid's shape alone, so that they do not move when a kernel is merged,
split or made to read another table.
"""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    bytes_per_s: float        # memory bandwidth
    fp32_flops: float         # float32 outside the tensor cores


# By a part of the name ``torch.cuda.get_device_name`` gives, first match
# wins (NVIDIA's data sheets, dense rates).
PEAKS = (
    ("H100 NVL", Peaks(3.9e12, 60e12)),
    ("H100 PCIe", Peaks(2.0e12, 51e12)),
    ("H100 80GB HBM3", Peaks(3.35e12, 67e12)),     # the SXM part
)

# Operations per grid point of a substep and of the physics epilogue, each
# rounded up (bench/roofline.py's tally: column scans, three scalar
# advections, two momentum equations and face fluxes; the epilogue's column
# profiles, diffusions, microphysics and surface with convection off).
FLOPS_PER_POINT = 350
EPILOGUE_FLOPS_PER_POINT = 350
STEP_FLOPS_PER_POINT = 2 * FLOPS_PER_POINT + EPILOGUE_FLOPS_PER_POINT

# float32, as bl3 and bl5 state; a reader of another configuration passes
# its own width (the run record's ``dtype``)
DTYPE_BYTES = 4


def peaks(name: str) -> Peaks:
    """The peaks of the card named ``name``. Raises on a card the table
    does not hold."""
    for key, pk in PEAKS:
        if key in name:
            return pk
    raise ValueError(f"no peaks known for the card {name!r} "
                     f"(known: {[k for k, _ in PEAKS]})")


def step_bytes_per_point(rad_every_steps: int,
                         dtype_bytes: int = DTYPE_BYTES) -> float:
    """Least memory traffic a grid point of one full-physics Matsuno step:
    25 traversals of the dynamics (each of u, v, pott, qv, qc read and
    written by both substeps, and the corrector's re-read of the t_n
    state), 2 reads of the cached radiative heating, and the radiation's
    own 4 traversals once every ``rad_every_steps`` steps."""
    return (25 + 2 + 4.0 / max(rad_every_steps, 1)) * dtype_bytes


def step_bytes(nx: int, ny: int, nz: int, rad_every_steps: int,
               dtype_bytes: int = DTYPE_BYTES) -> float:
    return step_bytes_per_point(rad_every_steps, dtype_bytes) * nx * ny * nz


def step_flops(nx: int, ny: int, nz: int) -> float:
    return float(STEP_FLOPS_PER_POINT) * nx * ny * nz


# A substep's fields: (3-D fields read, 2-D fields read, 3-D written, 2-D
# written). The predictor reads u, v, pott, qv, qc and the radiative
# heating, colp and the surface height, and writes the five and colp. The
# corrector with its physics epilogue, counted as one substep, also reads
# the five and colp of the t_n state, and the surface fields (tsurf, rain,
# soil water, the two cached surface fluxes, land mask, evaporation
# efficiency), and writes tsurf, rain and soil water.
SUBSTEP_FIELDS = {
    "predictor": (6, 2, 5, 1),
    "corrector": (11, 3 + 7, 5, 1 + 3),
}


def substep_bytes(kind: str, nx: int, ny: int, nz: int,
                  dtype_bytes: int = DTYPE_BYTES) -> float:
    r3, r2, w3, w2 = SUBSTEP_FIELDS[kind]
    return float(dtype_bytes) * ((r3 + w3) * nz * ny * nx
                                 + (r2 + w2) * ny * nx)


def substep_flops(kind: str, nx: int, ny: int, nz: int) -> float:
    per = FLOPS_PER_POINT + (EPILOGUE_FLOPS_PER_POINT
                             if kind == "corrector" else 0)
    return float(per) * nx * ny * nz


def least_s(n_bytes: float, n_flops: float, pk: Peaks) -> float:
    """The least time of work at the card's peaks: the larger of its bytes
    over the memory rate and its operations over the fp32 rate."""
    return max(n_bytes / pk.bytes_per_s, n_flops / pk.fp32_flops)
