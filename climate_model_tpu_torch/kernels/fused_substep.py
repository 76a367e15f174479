"""Fused dycore substep: the hand-written CUDA kernels, their wrappers and
their plain PyTorch version.

Port of the variants of ``climate_model_tpu/kernels/fused_substep.py::
make_fused_substep_packed`` that the Matsuno paths launch, and the port's
own RK4 stage on the same machinery (below): the predictor
(``same_base=True``) and the corrector (``same_base=False``), with the
radiative source and horizontal diffusion switched by launch arguments; the
v wall either by row index or from a ``(ny,)`` mask (``wall_mask=True``);
the packed scan's corrector, which also runs the physics epilogue
(surface, turbulence and microphysics, ``phys=``); and, on the sharded
packed path (``dist/packed_halo.py``), the same launches on a shard's block
and on the seam strips of the halo-overlap schedule (the header of
``csrc/fused_substep.cu`` says why the lon wrap, wrong at a block's edge,
stays in its ghost columns). The kernel sources are
``csrc/fused_substep.cu`` (the substep, one launch) and
``csrc/physics_epilogue.cu`` (the epilogue, a second launch), with the
warp-per-column helpers of ``csrc/column.cuh`` and the strips, runs and
counters of ``csrc/march.cuh``; their headers say how both kernels' persistent
grids march along latitude through their rings of staged rows and what
bounds each on the card. ``launch_plan`` sizes both and their shared
memory.

* ``predictor`` / ``corrector`` are the wrappers. On a CUDA tensor they
  launch the kernels (fp32, 2 to ``MAX_NZ`` levels) or raise; on a CPU
  tensor they call the plain version. Each counts its launches per variant
  in the port's counters (``trace.py``): on a whole grid (``part="grid"``)
  ``predictor`` / ``predictor.masked`` (index rule / mask), ``corrector``
  / ``corrector.masked`` (without the epilogue) and
  ``corrector.epilogue``; on a shard's block and on the south and north
  seam strips ``<wrapper>.shard``, ``.south_strip`` and ``.north_strip``.
* ``fused_substep_plain`` is the plain version: the stepper's ``substep``,
  then, with ``phys``, the port's own surface, turbulence and microphysics
  splits on the pressure of the new colp (``epilogue_plain``). The CPU
  tests use it, and ``chip_smoke.py`` holds the kernels against it on the
  card.
* ``rk4_stage`` is one stage of RK4 on the conserved variables
  (``dycore/stepper.py::step_rk4``) on a whole grid, ``rk4_stage_kernel<1>``
  to ``<4>`` of ``csrc/fused_substep.cu``: the tendencies at the stage
  state, the next stage state from the t_n state, and w dt k into an
  accumulator in device memory (``rk4_accumulator``); its plain version,
  ``rk4_stage_plain``, composes ``tendencies`` and ``proceed``. It counts
  ``rk4_stage.k1`` to ``.k4``. ``epilogue`` launches the physics epilogue
  alone, after the last stage (counted as ``epilogue``).
  The RK4 step runs on one device only: the stage has no shard-local or
  seam-strip variant.

``dt`` and the autoconversion fraction reach every kernel as a runtime
operand, a float32 ``(dt, frac)`` on the device (``StepScalars``; the
reference's ``jnp.stack([dt_s, frac])``): the eager path keeps one buffer
per value, a captured step (``graphs.py``) its own, which a new dt
rewrites.

The library is built at first use with one ``nvcc`` call over every
``csrc/*.cu`` into ``climate_model_tpu_torch/_build/`` (named by a hash of
the sources and headers, so an edit rebuilds) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..core.config import ModelConfig, NumericsConfig, PhysicsConfig
from ..core.grid import Grid
from ..core.state import Forcing, State
from ..trace import count

GEO_FIELDS = ("area", "area_v", "dx", "dxs", "corf", "corf_v",
              "tan_lat", "tan_lat_v", "kdiff_uv", "kdiff_pott",
              "kdiff_moist")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "kernels", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The physics-epilogue parameters, in the order of ``model.py::
# phys_epilogue_tuple`` (the reference's ``phys=`` tuple).
PHYS_FIELDS = ("surface", "turbulence", "microphysics", "drag_coef",
               "soil_heat_capacity", "ocean_heat_capacity",
               "qc_autoconv_time", "qc_autoconv_threshold",
               "diff_coef_scalar", "diff_coef_momentum", "soil_moisture",
               "soil_moist_cap", "convection", "conv_diffusivity",
               "conv_rh_crit")
PARTS = ("grid", "shard", "south_strip", "north_strip")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "cm_fused_substep_f32": [_P] * 24 + [_I] * 7 + [_P] + [_F] * 2 + [_I] * 3
                            + [_P],
    "cm_physics_epilogue_f32": [_P] * 25 + [_I] * 8 + [_P] + [_F] + [_I] * 5
                               + [_F] * 9 + [_P],
    "cm_rk4_stage_f32": [_P] * 30 + [_I] * 7 + [_P] + [_F] * 2 + [_I] * 3
                        + [_P],
    "cm_slab_copy": [_P, _I, _I, _P],           # kernels/halo_copy.py
    "cm_slab_copy_layout": [_P],
}

# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448         # shared memory a block may use (H100: 227 KB)
SMS = 132                    # streaming multiprocessors of the H100
BLOCKS_PER_SM = 1            # both kernels': one persistent block an SM
MAX_NZ = 128                 # 4 levels a lane of a warp (csrc/column.cuh)
STRIP_WIDTHS = (32, 16, 8, 4)  # longitudes a strip, widest first
RING_DEPTHS = (6, 5)         # staged rows of the substep's ring, deepest first
EPILOGUE_DEPTHS = (6, 5)     # ... of the epilogue's (its kMinDepth is 5)
EPILOGUE_PROFILE_ROWS = 4    # rows of the epilogue's profile ring (kProfRows)
EPILOGUE_STATIC_SMEM = 1024  # the epilogue's static shared memory, at most
LONG_RUN_ROWS = 4            # rows a run from which an epilogue physics task
LONG_RUN_PHYS_COLS = 2       # ... takes this many columns (else one)


def _pitch(n: int) -> int:
    """The least n' >= n with n' = 4 mod 8 (``pitch`` of
    ``csrc/fused_substep.cu``)."""
    return n + (4 - n) % 8


def substep_smem_floats(nz: int, tx: int, depth: int,
                        stage: bool = False) -> int:
    """Shared memory of the substep's ring for strips of tx longitudes and
    ``depth`` staged rows, in floats (``Ring`` of ``csrc/fused_substep.cu``):
    the staged rows' five fields, base COLP and surface height, a line of
    tx + 5 longitudes each at a pitch of 4 mod 8; COLP's line of depth + 1
    rows; the geometry of depth rows; three rows of scans (wwind, phi,
    pvtf, COLP_new, base COLP, dCOLP/dt, and an RK4 ``stage``'s next COLP)
    and two of scratch (phi's layer part, the surface Exner factor), tx + 1
    columns at an odd pitch; sigma_vb and dsigma."""
    p, ex = _pitch(tx + 5), (tx + 1) | 1
    return (depth * (5 * nz + 2) * p + (depth + 1) * p
            + depth * len(GEO_FIELDS) + 3 * (3 * nz + 4 + stage) * ex
            + 2 * (nz + 1) * ex + 2 * nz + 1)


def epilogue_smem_floats(nz: int, tx: int, depth: int) -> int:
    """Shared memory of the epilogue's rings for strips of tx longitudes and
    ``depth`` staged rows, in floats (``Ring`` of
    ``csrc/physics_epilogue.cu``): a staged row's pott, u, v, qv and qc, a
    (field, level) line of tx + 4 longitudes each at a pitch of 4 mod 8;
    ``EPILOGUE_PROFILE_ROWS`` rows of the 4 profile arrays and the layer
    Exner factors (each column's levels at an odd pitch), the 8 surface
    scalars and the surface Exner factor of the strip's columns and the
    west one; sigma_vb and dsigma."""
    nzp, ex = nz | 1, tx + 1
    return (depth * 5 * nz * _pitch(tx + 4)
            + EPILOGUE_PROFILE_ROWS * (5 * ex * nzp + 9 * ex) + 2 * nz + 1)


@dataclasses.dataclass(frozen=True)
class SubstepPlan:
    """The substep's persistent grid: ceil(nx / tx) strips of equal width
    (``strip_starts``), their (strip, row) units dealt to ``blocks`` blocks
    in runs of equal weight (a unit weighs its strip's ``pass_lanes``), each
    block walking its run south to north through a ring of ``depth`` staged
    rows."""
    tx: int                  # longitudes a strip at most
    depth: int               # staged rows in the ring
    blocks: int              # blocks of the grid (one an SM at most)
    smem_bytes: int          # dynamic shared memory a block
    staged_rows_per_row: float   # (field, level) lines copied / needed
    scanned_cols_per_col: float  # column scans computed / grid columns


@dataclasses.dataclass(frozen=True)
class EpiloguePlan:
    """The epilogue's persistent grid, by the substep's rules
    (``SubstepPlan``): strips of at most ``tx`` longitudes, balanced runs,
    a ring of ``depth`` staged rows."""
    tx: int                  # longitudes a strip at most
    depth: int               # staged rows in the ring
    blocks: int              # blocks of the grid (one an SM at most)
    phys_cols: int           # columns a physics task
    smem_bytes: int          # dynamic shared memory a block
    staged_rows_per_row: float     # 3-D floats copied / needed
    profiled_cols_per_col: float   # surface cores and profiles / columns


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    substep: SubstepPlan
    epilogue: EpiloguePlan


def strip_starts(nx: int, tx: int) -> list:
    """The first longitude of each of the ceil(nx / tx) substep strips, and
    nx: widths equal to within q, the largest of 4, 2, 1 dividing nx, each
    start a multiple of q (``strip_start`` of ``csrc/fused_substep.cu``)."""
    q = 4 if nx % 4 == 0 else 2 if nx % 2 == 0 else 1
    strips = -(-nx // tx)
    return [q * (s * (nx // q) // strips) for s in range(strips + 1)]


def pass_lanes(ncol: int) -> int:
    """The lanes an update pass of a strip of ncol columns spans: ncol
    rounded up to a power of two (``pass_lanes`` of
    ``csrc/fused_substep.cu``), what a row of the strip costs."""
    lanes = 1
    while lanes < ncol:
        lanes *= 2
    return lanes


def run_start(ny: int, nx: int, tx: int, blocks: int, b: int) -> int:
    """The first (strip, row) unit of block b's run, unit = strip * ny +
    row: a unit weighs its strip's ``pass_lanes`` and belongs to the block
    whose share of the weight (b / blocks to (b + 1) / blocks of the whole)
    holds its midpoint; as many blocks as units give each block one
    (``run_start`` of ``csrc/fused_substep.cu``)."""
    starts = strip_starts(nx, tx)
    units = (len(starts) - 1) * ny
    if blocks >= units:
        return min(b, units)
    lanes = [pass_lanes(e - s) for s, e in zip(starts, starts[1:])]
    share, g = b * sum(lanes) * ny, blocks         # the target: share / g
    before = 0
    for s, w in enumerate(lanes):
        if (before + w * ny) * g > share or s == len(lanes) - 1:
            num = 2 * share - g * (2 * before + w)
            j = 0 if num <= 0 else -(-num // (2 * g * w))
            return (s + 1) * ny if j >= ny else s * ny + j
        before += w * ny


def substep_segments(ny: int, nx: int, tx: int, blocks: int) -> list:
    """Each block's run as the segments it walks: (strip, first row, end
    row) within one strip, in the order of the kernel."""
    out = []
    for b in range(blocks):
        u, u1, segs = run_start(ny, nx, tx, blocks, b), run_start(
            ny, nx, tx, blocks, b + 1), []
        while u < u1:
            s, j0 = divmod(u, ny)
            j1 = min(ny, j0 + u1 - u)
            segs.append((s, j0, j1))
            u += j1 - j0
        out.append(segs)
    return out


def _substep_counts(ny: int, nx: int, tx: int, blocks: int) -> tuple:
    """(staged_rows_per_row, scanned_cols_per_col) of the plan: a segment
    of rows j0 .. j1-1 copies rows j0-1 .. j1 (those in the grid) of its
    strip's columns and one around, and scans rows j0-1 (where there is
    one) .. j1-1 of its columns and one west."""
    starts = strip_starts(nx, tx)
    staged = scanned = 0
    for segs in substep_segments(ny, nx, tx, blocks):
        for s, j0, j1 in segs:
            ncol = starts[s + 1] - starts[s]
            staged += (min(j1, ny - 1) - max(j0 - 1, 0) + 1) * (ncol + 2)
            scanned += (j1 - j0 + (j0 > 0)) * (ncol + 1)
    return staged / (ny * nx), scanned / (ny * nx)


def _march(floats, nz: int, ny: int, nx: int,
           depths: tuple = RING_DEPTHS, reserve: int = 0) -> tuple:
    """(tx, depth, blocks) of a marching kernel whose ring takes
    ``floats(nz, tx, depth)`` floats: the widest strip whose ring fits a
    block beside ``reserve`` bytes, then the deepest ring of ``depths`` that
    fits it; as many blocks as SMs (or units)."""
    fits = [(tx, d) for tx in STRIP_WIDTHS for d in depths
            if 4 * floats(nz, tx, d) + reserve <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no strip of {nz} levels fits {SMEM_LIMIT} bytes "
                         "of shared memory")
    tx = fits[0][0]
    depth = next(d for w, d in fits if w == tx)
    return tx, depth, min(SMS * BLOCKS_PER_SM, -(-nx // tx) * ny)


def _substep_plan(nz: int, ny: int, nx: int,
                  stage: bool = False) -> SubstepPlan:
    """The substep's strips, ring and grid (``_march``)."""
    tx, depth, blocks = _march(
        lambda n, w, d: substep_smem_floats(n, w, d, stage), nz, ny, nx)
    staged, scanned = _substep_counts(ny, nx, tx, blocks)
    return SubstepPlan(tx=tx, depth=depth, blocks=blocks,
                       smem_bytes=4 * substep_smem_floats(nz, tx, depth,
                                                          stage),
                       staged_rows_per_row=staged,
                       scanned_cols_per_col=scanned)


def _epilogue_counts(ny: int, nx: int, tx: int, blocks: int) -> tuple:
    """(staged_rows_per_row, profiled_cols_per_col) of the epilogue's plan:
    a segment of rows j0 .. j1-1 copies its rows' pott with the west column
    and their u, v, qv and qc, and pott of the row below (where there is
    one); it computes the surface cores and profiles of rows j0-1 (where
    there is one) .. j1-1 of its columns and one west."""
    starts = strip_starts(nx, tx)
    staged = profiled = 0
    for segs in substep_segments(ny, nx, tx, blocks):
        for s, j0, j1 in segs:
            ncol = starts[s + 1] - starts[s]
            staged += (j1 - j0) * (5 * ncol + 1) + (j0 > 0) * (ncol + 1)
            profiled += (j1 - j0 + (j0 > 0)) * (ncol + 1)
    return staged / (5 * ny * nx), profiled / (ny * nx)


def _epilogue_plan(nz: int, ny: int, nx: int) -> EpiloguePlan:
    """The epilogue's strips, ring and grid (``_march``); a physics task
    takes ``LONG_RUN_PHYS_COLS`` columns where the runs average
    ``LONG_RUN_ROWS`` rows or more, else one (a short run has too few rows
    to keep every warp busy with fewer tasks)."""
    tx, depth, blocks = _march(epilogue_smem_floats, nz, ny, nx,
                               EPILOGUE_DEPTHS, EPILOGUE_STATIC_SMEM)
    staged, profiled = _epilogue_counts(ny, nx, tx, blocks)
    units = (len(strip_starts(nx, tx)) - 1) * ny
    long_runs = units >= LONG_RUN_ROWS * blocks
    return EpiloguePlan(tx=tx, depth=depth, blocks=blocks,
                        phys_cols=LONG_RUN_PHYS_COLS if long_runs else 1,
                        smem_bytes=4 * epilogue_smem_floats(nz, tx, depth),
                        staged_rows_per_row=staged,
                        profiled_cols_per_col=profiled)


@functools.lru_cache(maxsize=None)
def launch_plan(nz: int, ny: int, nx: int) -> LaunchPlan:
    """The strips, ring and grid of the substep and of the epilogue, with
    their dynamic shared memory, on a (nz, ny, nx) block,
    computed once per shape. Raises ValueError on a shape the kernels do
    not take: fewer than 2 or more than ``MAX_NZ`` levels, or an empty
    grid."""
    if not 2 <= nz <= MAX_NZ:
        raise ValueError(f"the kernels take 2 to {MAX_NZ} levels, not {nz}")
    if ny < 1 or nx < 1:
        raise ValueError(f"empty grid {ny}x{nx}")
    return LaunchPlan(substep=_substep_plan(nz, ny, nx),
                      epilogue=_epilogue_plan(nz, ny, nx))


@functools.lru_cache(maxsize=None)
def rk4_stage_plan(nz: int, ny: int, nx: int) -> SubstepPlan:
    """The RK4 stage's persistent grid on a (nz, ny, nx) block: the
    substep's, with the stage's scan slots (one more row each). Raises
    ValueError where ``launch_plan`` does, or where no ring fits."""
    launch_plan(nz, ny, nx)
    return _substep_plan(nz, ny, nx, stage=True)


@dataclasses.dataclass
class BuildInfo:
    path: str          # the shared library
    seconds: float     # nvcc wall time (0.0 when an existing build was loaded)
    log: str           # nvcc's output (-Xptxas -v: registers, smem, spills)


_loaded = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(force: bool = False) -> BuildInfo:
    """Compile every ``csrc/*.cu`` in one ``nvcc`` call (route (b): plain C
    interface, no PyTorch headers) unless a library built from the same
    sources exists. Returns where it is, how long nvcc took and its log."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256()
    for s in sorted(sources + glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libcm_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(path) and not force:
        return BuildInfo(path=path, seconds=0.0, log="")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return BuildInfo(path=path, seconds=seconds,
                     log=proc.stdout + proc.stderr)


def _lib():
    """The loaded kernel library (built at first use)."""
    if "lib" not in _loaded:
        lib = ctypes.CDLL(build().path)
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


def geo_table(grid: Grid) -> torch.Tensor:
    """The per-latitude geometry as one contiguous (ny, 11) table in
    ``GEO_FIELDS`` order (what the kernel reads)."""
    return torch.stack([getattr(grid, f) for f in GEO_FIELDS], dim=1)


def wall_mask(ny: int, dtype, device) -> torch.Tensor:
    """The single-device v-wall mask: 1 on the interior v rows, 0 on the
    south-wall row 0 (the north wall row is not stored). The reference
    packs it into AUX2 slot 4 (``kernels/packing.py::pack_aux``); a
    latitude shard would pass its own rows."""
    mask = torch.ones(ny, dtype=dtype, device=device)
    mask[0] = 0.0
    return mask


# ---------------------------------------------------------------------------
# The runtime scalars
# ---------------------------------------------------------------------------

def scalar_values(dt: float, tau: float | None) -> tuple:
    """``(float32(dt), frac)`` as the kernels read them: ``frac`` is
    ``_autoconv_frac(dt, tau)`` where the microphysics runs (``tau`` its
    autoconversion time), else 0."""
    return (float(np.float32(dt)),
            0.0 if tau is None else _autoconv_frac(dt, tau))


def autoconv_tau(phys: tuple | None) -> float | None:
    """The autoconversion time of the ``phys`` tuple where its
    microphysics is on, else None (``scalar_values``'s ``tau``)."""
    if phys is None:
        return None
    p = dict(zip(PHYS_FIELDS, phys))
    return p["qc_autoconv_time"] if p["microphysics"] else None


class StepScalars:
    """The kernels' runtime operand: a float32 ``(dt, frac)`` buffer on the
    device, the reference's ``jnp.stack([dt_s, frac])``
    (``climate_model_tpu/kernels/fused_substep.py:1063-1070``). A captured
    step (``graphs.py``) reads it on every replay, so a new dt is a write
    here and never a re-capture. ``dt`` is the host value last written: the
    plain versions take it as it is, in the working dtype, on the CPU."""

    def __init__(self, device, tau: float | None):
        self.tau = tau
        self.dt = None
        self.buf = torch.zeros(2, dtype=torch.float32, device=device)

    def set(self, dt: float) -> bool:
        """Write ``dt`` and its ``frac`` (two fills on the stream: no host
        sync). Returns whether the value changed."""
        if dt == self.dt:
            return False
        for slot, x in zip(self.buf, scalar_values(dt, self.tau)):
            slot.fill_(x)
        self.dt = dt
        return True

    def advance(self, t: torch.Tensor):
        """``t += dt`` in place: from the device scalar on the card (the
        float32 sum of ``t + dt``, as the eager step takes it), from the
        host value on the CPU."""
        t.add_(self.buf[0] if t.is_cuda else self.dt)


@functools.lru_cache(maxsize=64)
def _eager_scalars(device: torch.device, dt: float, tau) -> StepScalars:
    scalars = StepScalars(device, tau)
    scalars.set(dt)
    return scalars


def _scalars_ptr(dev, dt: float, phys: tuple | None,
                 scalars: StepScalars | None) -> int:
    """The device address of the ``(dt, frac)`` operand of one launch: the
    caller's ``scalars``, or a buffer cached per value (the eager path;
    never made under a capture, where it would hold no value)."""
    if scalars is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a captured launch takes its (dt, frac) "
                               "from a StepScalars (scalars=...)")
        scalars = _eager_scalars(dev, dt, autoconv_tau(phys))
    return scalars.buf.data_ptr()


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _plain_cfg(with_rad: bool, with_diff: bool) -> ModelConfig:
    """A config whose switches select the same terms as the kernel's
    arguments. Diffusion values come from the Grid's per-latitude tensors;
    the config floats only turn the terms on."""
    on = 1.0 if with_diff else 0.0
    return ModelConfig(physics=PhysicsConfig(radiation=with_rad),
                       numerics=NumericsConfig(diff_uv=on, diff_pott=on,
                                               diff_moist=on))


def _phys_cfg(phys: tuple) -> ModelConfig:
    """The config of the plain physics splits that the ``phys`` tuple
    selects (the epilogue's counterpart of ``_plain_cfg``)."""
    return ModelConfig(physics=PhysicsConfig(**dict(zip(PHYS_FIELDS, phys))))


def _apply_wall(state: State, vmask) -> State:
    if vmask is None:
        return state
    return state.replace(v=state.v * vmask[:, None])


def fused_substep_plain(ev: State, base: State | None, grid: Grid,
                        forcing: Forcing, dt: float, *, with_rad: bool,
                        with_diff: bool, phys: tuple | None = None,
                        vmask: torch.Tensor | None = None) -> State:
    """One substep in plain PyTorch (the stepper's ``substep`` with the
    kernel's terms): tendencies at ``ev`` advanced from ``base``
    (``base=None``: from ``ev``, the predictor). Returns ``base`` with u, v,
    pott, qv, qc and colp replaced.

    ``vmask`` multiplies v after the update, after the surface drag and
    after the turbulence, where the reference kernel applies its wall.
    ``phys`` (the corrector only) then runs the physics epilogue: the
    port's ``surface_step``, ``turbulence_step`` and ``microphysics_step``
    in that order, on the pressure of the new colp and the time-n surface
    fields of ``base``, which also replaces tsurf, rain and soil_moist."""
    from ..dycore.stepper import substep

    out = substep(ev, ev if base is None else base, dt, grid, forcing,
                  _plain_cfg(with_rad, with_diff))
    out = _apply_wall(out, vmask)
    if phys is None:
        return out
    return epilogue_plain(out, grid, forcing, dt, phys=phys, vmask=vmask)


def epilogue_plain(state: State, grid: Grid, forcing: Forcing, dt: float, *,
                   phys: tuple, vmask: torch.Tensor | None = None) -> State:
    """The physics epilogue in plain PyTorch, on a post-dynamics ``state``
    that carries the time-n surface fields: the port's ``surface_step``,
    ``turbulence_step`` and ``microphysics_step`` in that order, on the
    pressure of its colp, v multiplied by ``vmask`` after the surface drag
    and after the turbulence."""
    from ..dycore.operators import diagnose_pressure
    from ..physics.microphysics import microphysics_step
    from ..physics.surface import surface_step
    from ..physics.turbulence import turbulence_step

    out = state
    cfg = _phys_cfg(phys)
    press = diagnose_pressure(out.colp, grid)
    if cfg.physics.surface:
        out = _apply_wall(surface_step(out, grid, forcing, cfg, dt,
                                       press=press), vmask)
    if cfg.physics.turbulence:
        out = _apply_wall(turbulence_step(out, grid, forcing, cfg, dt,
                                          press=press), vmask)
    if cfg.physics.microphysics:
        out = microphysics_step(out, grid, forcing, cfg, dt, press=press)
    return out


# RK4 on the conserved variables (``dycore/stepper.py::step_rk4``): stage m
# evaluates k_m at its state, gives the next stage state y0 + c dt k_m
# (``RK4_C``, stages 1-3) and adds w dt k_m to the accumulator (``RK4_W``);
# the last stage gives y0 + the accumulator.
RK4_C = (0.5, 0.5, 1.0)
RK4_W = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
ACC_FIELDS = ("u", "v", "pott", "qv", "qc", "colp")


def rk4_accumulator(state: State) -> dict:
    """The accumulator of an RK4 step on ``state``'s grid: a tensor a field
    of ``ACC_FIELDS`` (the conserved tendencies' w dt k summed), unset."""
    return {f: torch.empty_like(getattr(state, f)) for f in ACC_FIELDS}


def rk4_stage_plain(ev: State, y0: State, acc: dict, grid: Grid,
                    forcing: Forcing, dt: float, *, stage: int,
                    with_rad: bool, with_diff: bool,
                    vmask: torch.Tensor | None = None) -> State:
    """RK4 stage ``stage`` (1 to 4) in plain PyTorch, with the kernel's
    terms: the tendencies k at ``ev`` (``tendencies(ev, ev.colp, dt)``, as
    ``step_rk4`` evaluates them), w dt k into ``acc`` (set at stage 1, added
    at 2 and 3; read, not written, at 4), and the next state: ``proceed``
    from the t_n state ``y0`` by c dt, with COLP_new = COLP0 + c dt dCOLP/dt;
    at stage 4 ``proceed`` from ``y0`` by the accumulator (dt 1). Returns
    ``y0`` with u, v, pott, qv, qc and colp replaced, v times ``vmask``."""
    from ..dycore.tendencies import proceed, tendencies

    tend = tendencies(ev, ev.colp, dt, grid, forcing,
                      _plain_cfg(with_rad, with_diff))
    if vmask is not None:
        tend = tend._replace(dvdt=tend.dvdt * vmask[:, None])
    k = dict(u=tend.dudt, v=tend.dvdt, pott=tend.dpottdt, qv=tend.dqvdt,
             qc=tend.dqcdt, colp=tend.dcolpdt)
    wdt = RK4_W[stage - 1] * dt
    if stage == 4:
        total = {f: acc[f] + wdt * k[f] for f in ACC_FIELDS}
        tend = tend._replace(dudt=total["u"], dvdt=total["v"],
                             dpottdt=total["pott"], dqvdt=total["qv"],
                             dqcdt=total["qc"],
                             colp_new=y0.colp + total["colp"])
        out = proceed(y0, tend, 1.0)
    else:
        for f in ACC_FIELDS:
            if stage == 1:
                acc[f].copy_(wdt * k[f])
            else:
                acc[f].add_(wdt * k[f])
        cdt = RK4_C[stage - 1] * dt
        out = proceed(y0, tend._replace(colp_new=y0.colp
                                        + cdt * tend.dcolpdt), cdt)
    return _apply_wall(out, vmask)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_FIELDS3 = ("u", "v", "pott", "qv", "qc")
_FIELDS2 = ("tsurf", "rain", "soil_moist", "swflx_sfc", "lwflx_sfc")
_FIELDS2_OUT = ("tsurf", "rain", "soil_moist")
_EPI_SWITCHES = ("surface", "turbulence", "microphysics", "soil_moisture",
                 "convection")
_EPI_PARAMS = ("drag_coef", "soil_heat_capacity", "ocean_heat_capacity",
               "qc_autoconv_threshold", "diff_coef_scalar",
               "diff_coef_momentum", "soil_moist_cap", "conv_diffusivity",
               "conv_rh_crit")


def _check(name, t, shape, device, dtype):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _out_fields(phys: tuple | None) -> tuple:
    """The fields a launch writes: the substep's, and the epilogue's
    2-D fields with ``phys``."""
    return _FIELDS3 + ("colp",) + (_FIELDS2_OUT if phys is not None
                                   else ())


def _validate(ev: State, base: State | None, grid: Grid, forcing: Forcing,
              with_rad: bool, phys: tuple | None = None, vmask=None,
              geo=None, out=None):
    """Device, dtype, shape and contiguity of every tensor the kernels
    read or, with ``out``, write; the length of ``phys`` and the mask. On
    the card the dtype must be float32 (the kernels' only type); on the
    CPU every tensor must share the dtype of ``ev.u``."""
    dev = ev.u.device
    if dev.type == "cuda":
        dtype = torch.float32
    elif dev.type == "cpu":
        dtype = ev.u.dtype
    else:
        raise ValueError(f"fused_substep runs on cuda or cpu, not {dev}")
    nz, ny, nx = ev.u.shape
    s3, s2 = (nz, ny, nx), (ny, nx)
    states = [("ev", ev)] + ([("base", base)] if base is not None else [])
    for sname, st in states:
        for f in _FIELDS3:
            _check(f"{sname}.{f}", getattr(st, f), s3, dev, dtype)
        _check(f"{sname}.colp", st.colp, s2, dev, dtype)
    _check("forcing.hsurf", forcing.hsurf, s2, dev, dtype)
    if with_rad:
        _check("ev.dpottdt_rad", ev.dpottdt_rad, s3, dev, dtype)
    for f in GEO_FIELDS:
        _check(f"grid.{f}", getattr(grid, f), (ny,), dev, dtype)
    _check("grid.sigma_vb", grid.sigma_vb, (nz + 1,), dev, dtype)
    _check("grid.dsigma", grid.dsigma, (nz,), dev, dtype)
    if vmask is not None:
        _check("vmask", vmask, (ny,), dev, dtype)
    if phys is not None:
        if not isinstance(phys, tuple) or len(phys) != len(PHYS_FIELDS):
            raise ValueError(f"phys: expected a tuple of {len(PHYS_FIELDS)} "
                             f"parameters {PHYS_FIELDS}, got {phys!r}")
        for f in _FIELDS2:
            _check(f"base.{f}", getattr(base, f), s2, dev, dtype)
        for f in ("land_mask", "evap_eff"):
            _check(f"forcing.{f}", getattr(forcing, f), s2, dev, dtype)
    if geo is not None:
        _check("geo", geo, (ny, len(GEO_FIELDS)), dev, dtype)
    if out is not None:
        names = _out_fields(phys)
        if set(out) != set(names):
            raise ValueError(f"out: expected the fields {names}, got "
                             f"{tuple(out)}")
        for f in names:
            _check(f"out.{f}", out[f], s3 if f in _FIELDS3 else s2, dev,
                   dtype)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(ev: State, base: State | None, grid: Grid, forcing: Forcing,
            dt: float, with_rad: bool, with_diff: bool, phys: tuple | None,
            vmask, scalars: StepScalars | None, geo, out) -> State:
    dev = ev.u.device
    nz, ny, nx = ev.u.shape
    s3 = (nz, ny, nx)
    b = ev if base is None else base
    plan = launch_plan(nz, ny, nx)

    def empty(shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if geo is None:
        geo = geo_table(grid)
    if out is None:
        out = {f: empty(s3) for f in _FIELDS3}
        out["colp"] = empty((ny, nx))
        if phys is not None:
            out.update({f: empty((ny, nx)) for f in _FIELDS2_OUT})
    # with the epilogue, the substep writes the post-dynamics fields, which
    # the epilogue reads, and the epilogue writes the outputs; COLP_new is
    # the substep's
    dyn = {f: empty(s3) for f in _FIELDS3} if phys is not None else out
    colp = out["colp"]
    rad_ptr = ev.dpottdt_rad.data_ptr() if with_rad else None
    scal = _scalars_ptr(dev, dt, phys, scalars)
    lib = _lib()
    sp, ep = plan.substep, plan.epilogue
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cm_fused_substep_f32(
            *(getattr(ev, f).data_ptr() for f in _FIELDS3), ev.colp.data_ptr(),
            *(getattr(b, f).data_ptr() for f in _FIELDS3), b.colp.data_ptr(),
            forcing.hsurf.data_ptr(), rad_ptr, geo.data_ptr(),
            grid.sigma_vb.data_ptr(), grid.dsigma.data_ptr(), _ptr(vmask),
            *(dyn[f].data_ptr() for f in _FIELDS3), colp.data_ptr(),
            nz, ny, nx, sp.tx, sp.depth, sp.blocks, sp.smem_bytes,
            scal, float(grid.dy), float(grid.ptop),
            int(base is None), int(with_rad), int(with_diff), stream)
        if err != 0:
            raise RuntimeError(f"fused_substep launch failed: CUDA error "
                               f"{err}")
        if phys is None:
            return b.replace(**out)
        _epilogue_call(lib, dyn, colp, b, grid, forcing, phys, vmask, ep,
                       scal, out, stream)
    return b.replace(**out)


def _epilogue_call(lib, dyn: dict, colp, b: State, grid: Grid,
                   forcing: Forcing, phys: tuple, vmask, ep: EpiloguePlan,
                   scal: int, out: dict, stream):
    """One launch of ``epilogue_kernel`` on the post-dynamics fields ``dyn``
    and ``colp``, with the time-n surface fields of ``b``, into ``out``."""
    nz, ny, nx = dyn["u"].shape
    p = dict(zip(PHYS_FIELDS, phys))
    err = lib.cm_physics_epilogue_f32(
        *(dyn[f].data_ptr() for f in _FIELDS3), colp.data_ptr(),
        *(getattr(b, f).data_ptr() for f in _FIELDS2),
        forcing.land_mask.data_ptr(), forcing.evap_eff.data_ptr(),
        forcing.hsurf.data_ptr(), _ptr(vmask), grid.sigma_vb.data_ptr(),
        grid.dsigma.data_ptr(),
        *(out[f].data_ptr() for f in _FIELDS3),
        *(out[f].data_ptr() for f in _FIELDS2_OUT),
        nz, ny, nx, ep.tx, ep.depth, ep.blocks, ep.phys_cols, ep.smem_bytes,
        scal, float(grid.ptop),
        *(int(bool(p[f])) for f in _EPI_SWITCHES),
        *(float(p[f]) for f in _EPI_PARAMS), stream)
    if err != 0:
        raise RuntimeError(f"physics epilogue launch failed: CUDA error "
                           f"{err}")


def _launch_stage(ev: State, y0: State, acc: dict, grid: Grid,
                  forcing: Forcing, dt: float, stage: int, with_rad: bool,
                  with_diff: bool, vmask, scalars: StepScalars | None, geo,
                  out) -> State:
    dev = ev.u.device
    nz, ny, nx = ev.u.shape
    sp = rk4_stage_plan(nz, ny, nx)
    if geo is None:
        geo = geo_table(grid)
    if out is None:
        out = {f: torch.empty_like(getattr(ev, f)) for f in ACC_FIELDS}
    rad_ptr = ev.dpottdt_rad.data_ptr() if with_rad else None
    scal = _scalars_ptr(dev, dt, None, scalars)
    with torch.cuda.device(dev):
        err = _lib().cm_rk4_stage_f32(
            *(getattr(ev, f).data_ptr() for f in ACC_FIELDS),
            *(getattr(y0, f).data_ptr() for f in ACC_FIELDS),
            forcing.hsurf.data_ptr(), rad_ptr, geo.data_ptr(),
            grid.sigma_vb.data_ptr(), grid.dsigma.data_ptr(), _ptr(vmask),
            *(out[f].data_ptr() for f in ACC_FIELDS),
            *(acc[f].data_ptr() for f in ACC_FIELDS),
            nz, ny, nx, sp.tx, sp.depth, sp.blocks, sp.smem_bytes,
            scal, float(grid.dy), float(grid.ptop),
            stage, int(with_rad), int(with_diff),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rk4_stage launch failed: CUDA error {err}")
    return y0.replace(**out)


def _plain(ev: State, base: State | None, grid: Grid, forcing: Forcing,
           dt: float, with_rad: bool, with_diff: bool, phys: tuple | None,
           vmask, scalars: StepScalars | None, out) -> State:
    """The plain version for a CPU tensor, with ``dt`` from ``scalars``
    where given; with ``out``, its fields are written into those
    tensors."""
    return _written(fused_substep_plain(
        ev, base, grid, forcing, dt if scalars is None else scalars.dt,
        with_rad=with_rad, with_diff=with_diff, phys=phys, vmask=vmask), out)


def _written(res: State, out: dict | None) -> State:
    """``res``, with its fields in ``out`` written into those tensors."""
    if out is None:
        return res
    for f, t in out.items():
        t.copy_(getattr(res, f))
    return res.replace(**out)


def _autoconv_frac(dt: float, tau: float) -> float:
    """1 - exp(-dt/tau) in fp32, as the reference's wrapper computes it
    (``kernels/fused_substep.py:1061-1070``) for its kernel."""
    one, x = np.float32(1.0), np.float32(-dt) / np.float32(tau)
    return float(one - np.exp(x))


def _check_part(part: str):
    if part not in PARTS:
        raise ValueError(f"part {part!r}: expected one of {PARTS}")


def _count(name: str, part: str, masked: bool, epilogue: bool = False):
    """Count a launch of the wrapper ``name`` on ``part``."""
    if part != "grid":
        name += f".{part}"
    elif epilogue:
        name += ".epilogue"
    elif masked:
        name += ".masked"
    count(name)


def predictor(ev: State, grid: Grid, forcing: Forcing, dt: float, *,
              with_rad: bool, with_diff: bool, vmask=None,
              part: str = "grid", scalars: StepScalars | None = None,
              geo=None, out: dict | None = None) -> State:
    """Matsuno predictor substep (tendencies at ``ev``, advanced from it).
    ``vmask``: the v wall as a (ny,) row mask (``wall_mask``) instead of
    the row index. ``part`` names what the block is, for the launch
    counters: ``"grid"``, ``"shard"``, ``"south_strip"`` or
    ``"north_strip"``. What a captured step (``graphs.py``) passes, so
    that a replay does no host work: ``scalars`` the ``(dt, frac)``
    operand (then ``dt`` is not read), ``geo`` the ``geo_table`` of
    ``grid``, ``out`` the tensors to write (u, v, pott, qv, qc and
    colp)."""
    _check_part(part)
    _validate(ev, None, grid, forcing, with_rad, vmask=vmask, geo=geo,
              out=out)
    if ev.u.device.type == "cpu":
        return _plain(ev, None, grid, forcing, dt, with_rad, with_diff,
                      None, vmask, scalars, out)
    res = _launch(ev, None, grid, forcing, dt, with_rad, with_diff, None,
                  vmask, scalars, geo, out)
    _count("predictor", part, vmask is not None)
    return res


def corrector(ev: State, base: State, grid: Grid, forcing: Forcing,
              dt: float, *, with_rad: bool, with_diff: bool,
              phys: tuple | None = None, vmask=None,
              part: str = "grid", scalars: StepScalars | None = None,
              geo=None, out: dict | None = None) -> State:
    """Matsuno corrector substep (tendencies at the predicted ``ev``,
    advanced from the time-n ``base``). ``phys`` (``model.py::
    phys_epilogue_tuple``) adds the physics epilogue (then ``out`` also
    holds tsurf, rain and soil_moist); ``vmask``, ``part``, ``scalars``,
    ``geo`` and ``out`` as for the predictor."""
    _check_part(part)
    _validate(ev, base, grid, forcing, with_rad, phys, vmask, geo, out)
    if ev.u.device.type == "cpu":
        return _plain(ev, base, grid, forcing, dt, with_rad, with_diff,
                      phys, vmask, scalars, out)
    res = _launch(ev, base, grid, forcing, dt, with_rad, with_diff, phys,
                  vmask, scalars, geo, out)
    _count("corrector", part, vmask is not None, epilogue=phys is not None)
    return res


def rk4_stage(ev: State, y0: State, acc: dict, grid: Grid,
              forcing: Forcing, dt: float, *, stage: int, with_rad: bool,
              with_diff: bool, vmask=None,
              scalars: StepScalars | None = None, geo=None,
              out: dict | None = None) -> State:
    """RK4 stage ``stage`` (1 to 4) on a whole grid: the tendencies at the
    stage state ``ev`` (``y0``, the t_n state, at stage 1), w dt k into the
    accumulator ``acc`` (``rk4_accumulator``; set at stage 1, read from
    stage 2, left unwritten at 4), and the next stage state advanced from
    ``y0``, or at stage 4 the step's state, returned as ``y0`` with u, v,
    pott, qv, qc and colp replaced (``rk4_stage_plain`` says how).
    ``vmask``, ``scalars``, ``geo`` and ``out`` as for the predictor. Counts
    ``rk4_stage.k<stage>``."""
    if stage not in (1, 2, 3, 4):
        raise ValueError(f"stage {stage!r}: expected 1, 2, 3 or 4")
    _validate(ev, y0, grid, forcing, with_rad, vmask=vmask, geo=geo,
              out=out)
    for f in ACC_FIELDS:
        _check(f"acc.{f}", acc.get(f), getattr(ev, f).shape, ev.u.device,
               ev.u.dtype)
    if ev.u.device.type == "cpu":
        return _written(rk4_stage_plain(
            ev, y0, acc, grid, forcing, dt if scalars is None else scalars.dt,
            stage=stage, with_rad=with_rad, with_diff=with_diff,
            vmask=vmask), out)
    res = _launch_stage(ev, y0, acc, grid, forcing, dt, stage, with_rad,
                        with_diff, vmask, scalars, geo, out)
    count(f"rk4_stage.k{stage}")
    return res


def epilogue(state: State, grid: Grid, forcing: Forcing, dt: float, *,
             phys: tuple, vmask=None, scalars: StepScalars | None = None,
             out: dict | None = None) -> State:
    """The physics epilogue alone (``epilogue_kernel``, the corrector's
    second launch) on a post-dynamics ``state`` that carries the time-n
    surface fields (``epilogue_plain`` says what it computes). ``out``
    holds u, v, pott, qv, qc, tsurf, rain and soil_moist; colp is
    ``state``'s. Counts ``epilogue``."""
    _validate(state, state, grid, forcing, False, phys, vmask)
    if out is not None:
        names = _FIELDS3 + _FIELDS2_OUT
        if set(out) != set(names):
            raise ValueError(f"out: expected the fields {names}, got "
                             f"{tuple(out)}")
        for f in names:
            _check(f"out.{f}", out[f], getattr(state, f).shape,
                   state.u.device, state.u.dtype)
    dev = state.u.device
    if dev.type == "cpu":
        return _written(epilogue_plain(
            state, grid, forcing, dt if scalars is None else scalars.dt,
            phys=phys, vmask=vmask), out)
    nz, ny, nx = state.u.shape
    if out is None:
        out = {f: torch.empty_like(getattr(state, f))
               for f in _FIELDS3 + _FIELDS2_OUT}
    dyn = {f: getattr(state, f) for f in _FIELDS3}
    with torch.cuda.device(dev):
        _epilogue_call(_lib(), dyn, state.colp, state, grid, forcing, phys,
                       vmask, launch_plan(nz, ny, nx).epilogue,
                       _scalars_ptr(dev, dt, phys, scalars), out,
                       torch.cuda.current_stream(dev).cuda_stream)
    count("epilogue")
    return state.replace(**out)
