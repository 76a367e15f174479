"""Fused dycore substep: the hand-written CUDA kernels, their wrappers and
their plain PyTorch version.

Port of the variants of ``climate_model_tpu/kernels/fused_substep.py::
make_fused_substep_packed`` that the Matsuno paths launch: the predictor
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
warp-per-column helpers of ``csrc/column.cuh``; their headers say how a
block's tile, its halo and the warp scans work and what bounds each on the
card. ``launch_plan`` sizes the tiles and their shared memory.

* ``predictor`` / ``corrector`` are the wrappers. On a CUDA tensor they
  launch the kernels (fp32, 2 to ``MAX_NZ`` levels) or raise; on a CPU
  tensor they call the plain version. Each counts its launches per variant
  in plain integer
  attributes. On a whole grid (``part="grid"``): ``predictor.launches`` /
  ``.masked_launches`` (index rule / mask), ``corrector.launches`` /
  ``.masked_launches`` (without the epilogue) and
  ``corrector.epilogue_launches``. On a shard's block and on the south and
  north seam strips: ``.shard_launches``, ``.south_strip_launches`` and
  ``.north_strip_launches`` of each wrapper.
* ``fused_substep_plain`` is the plain version: the stepper's ``substep``,
  then, with ``phys``, the port's own surface, turbulence and microphysics
  splits on the pressure of the new colp. The CPU tests use it, and
  ``chip_smoke.py`` holds the kernels against it on the card.

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
    "cm_fused_substep_f32": [_P] * 24 + [_I] * 6 + [_F] * 3 + [_I] * 3 + [_P],
    "cm_physics_epilogue_f32": [_P] * 25 + [_I] * 6 + [_F] * 3 + [_I] * 5
                               + [_F] * 9 + [_P],
}

# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448         # shared memory a block may use (H100: 227 KB)
SMEM_TWO_BLOCKS = 115_712    # ... with two blocks on an SM (228 KB, 1 KB each)
SMS = 132                    # streaming multiprocessors of the H100
MAX_NZ = 128                 # 4 levels a lane of a warp (csrc/column.cuh)
TILE_WIDTHS = (32, 16, 8)    # longitudes a tile, widest first


def substep_smem_floats(nz: int, tx: int, tj: int) -> int:
    """Shared memory of a substep tile of tj rows x tx longitudes, in
    floats (``Tile`` of ``csrc/fused_substep.cu``): the five fields with
    one column and row around; the scans' wwind, phi with its layer part,
    pvtf, COLP_new, base COLP, dCOLP/dt and the surface Exner factor for
    the tile with one column west and one row south; the COLP patch with
    two columns and rows around; the geometry of the rows with one around;
    sigma_vb and dsigma."""
    nzp, nwp = nz | 1, (nz + 1) | 1
    e = (tx + 1) * (tj + 1)
    return (5 * (tj + 2) * (tx + 2) * nzp + e * (nwp + 3 * nzp + 4)
            + (tj + 3) * (tx + 3) + (tj + 2) * len(GEO_FIELDS) + 2 * nz + 1)


def epilogue_smem_floats(nz: int, tx: int, tj: int) -> int:
    """Shared memory of an epilogue tile, in floats (``Tile`` of
    ``csrc/physics_epilogue.cu``): pott, the 4 profile arrays, the 8
    surface scalars, 3 2-D fields and the surface Exner factor of the tile
    with one column west and one row south; the tile's u, v, qv, qc and 6
    2-D fields; the bottom u and v with one column and row around; sigma_vb
    and dsigma."""
    nzp = nz | 1
    e = (tx + 1) * (tj + 1)
    return (e * nzp + 4 * tx * tj * nzp + 4 * e * nzp + 8 * e
            + 2 * (tx + 2) * (tj + 2) + 4 * e + 6 * tx * tj + 2 * nz + 1)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    tx: int                  # longitudes a tile
    tj: int                  # latitude rows a tile
    grid: tuple              # blocks along (lon, lat)
    smem_bytes: int          # dynamic shared memory a block


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    substep: TilePlan
    epilogue: TilePlan


def _tile(floats, nz: int, ny: int, nx: int, rows: tuple,
          budget: int) -> TilePlan:
    """The widest tile of one row whose shared memory fits a block; then
    the most rows of ``rows`` whose shared memory is at most ``budget``
    bytes while the grid keeps two blocks for each SM."""
    tx = next((w for w in TILE_WIDTHS if 4 * floats(nz, w, 1) <= SMEM_LIMIT),
              None)
    if tx is None:
        raise ValueError(f"no tile of {nz} levels fits {SMEM_LIMIT} bytes "
                         "of shared memory")
    gx = -(-nx // tx)
    tj = next((n for n in rows if 4 * floats(nz, tx, n) <= budget
               and gx * -(-ny // n) >= 2 * SMS), 1)
    return TilePlan(tx=tx, tj=tj, grid=(gx, -(-ny // tj)),
                    smem_bytes=4 * floats(nz, tx, tj))


@functools.lru_cache(maxsize=None)
def launch_plan(nz: int, ny: int, nx: int) -> LaunchPlan:
    """The tiles, grids and dynamic shared memory of the substep and
    epilogue launches on a (nz, ny, nx) block, computed once per shape.
    Raises ValueError on a shape the kernels do not take: fewer than 2 or
    more than ``MAX_NZ`` levels, or an empty grid."""
    if not 2 <= nz <= MAX_NZ:
        raise ValueError(f"the kernels take 2 to {MAX_NZ} levels, not {nz}")
    if ny < 1 or nx < 1:
        raise ValueError(f"empty grid {ny}x{nx}")
    return LaunchPlan(
        # the substep runs one block of 16 warps an SM, the epilogue two
        # blocks an SM at up to 32 levels
        substep=_tile(substep_smem_floats, nz, ny, nx, (3, 2), SMEM_LIMIT),
        epilogue=_tile(epilogue_smem_floats, nz, ny, nx, (2,),
                       SMEM_TWO_BLOCKS))


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
    from ..dycore.operators import diagnose_pressure
    from ..dycore.stepper import substep
    from ..physics.microphysics import microphysics_step
    from ..physics.surface import surface_step
    from ..physics.turbulence import turbulence_step

    out = substep(ev, ev if base is None else base, dt, grid, forcing,
                  _plain_cfg(with_rad, with_diff))
    out = _apply_wall(out, vmask)
    if phys is None:
        return out
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


def _validate(ev: State, base: State | None, grid: Grid, forcing: Forcing,
              with_rad: bool, phys: tuple | None = None, vmask=None):
    """Device, dtype, shape and contiguity of every tensor the kernels
    read, the length of ``phys`` and the mask. On the card the dtype must
    be float32 (the kernels' only type); on the CPU every tensor must share
    the dtype of ``ev.u``."""
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(ev: State, base: State | None, grid: Grid, forcing: Forcing,
            dt: float, with_rad: bool, with_diff: bool, phys: tuple | None,
            vmask) -> State:
    dev = ev.u.device
    nz, ny, nx = ev.u.shape
    s3 = (nz, ny, nx)
    b = ev if base is None else base
    plan = launch_plan(nz, ny, nx)

    def empty(shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    geo = geo_table(grid)
    out = {f: empty(s3) for f in _FIELDS3}
    # with the epilogue, the substep writes the post-dynamics fields, which
    # the epilogue reads, and the epilogue writes the outputs
    dyn = {f: empty(s3) for f in _FIELDS3} if phys is not None else out
    colp = empty((ny, nx))
    rad_ptr = ev.dpottdt_rad.data_ptr() if with_rad else None
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
            nz, ny, nx, sp.tx, sp.tj, sp.smem_bytes,
            float(dt), float(grid.dy), float(grid.ptop),
            int(base is None), int(with_rad), int(with_diff), stream)
        if err != 0:
            raise RuntimeError(f"fused_substep launch failed: CUDA error "
                               f"{err}")
        if phys is None:
            return b.replace(colp=colp, **out)
        new2 = {f: empty((ny, nx)) for f in _FIELDS2_OUT}
        p = dict(zip(PHYS_FIELDS, phys))
        err = lib.cm_physics_epilogue_f32(
            *(dyn[f].data_ptr() for f in _FIELDS3), colp.data_ptr(),
            *(getattr(b, f).data_ptr() for f in _FIELDS2),
            forcing.land_mask.data_ptr(), forcing.evap_eff.data_ptr(),
            forcing.hsurf.data_ptr(), _ptr(vmask), grid.sigma_vb.data_ptr(),
            grid.dsigma.data_ptr(),
            *(out[f].data_ptr() for f in _FIELDS3),
            *(new2[f].data_ptr() for f in _FIELDS2_OUT),
            nz, ny, nx, ep.tx, ep.tj, ep.smem_bytes,
            float(dt), float(grid.ptop),
            _autoconv_frac(dt, p["qc_autoconv_time"]) if p["microphysics"]
            else 0.0,
            *(int(bool(p[f])) for f in _EPI_SWITCHES),
            *(float(p[f]) for f in _EPI_PARAMS), stream)
    if err != 0:
        raise RuntimeError(f"physics epilogue launch failed: CUDA error "
                           f"{err}")
    return b.replace(colp=colp, **out, **new2)


def _autoconv_frac(dt: float, tau: float) -> float:
    """1 - exp(-dt/tau) in fp32, as the reference's wrapper computes it
    (``kernels/fused_substep.py:1061-1070``) for its kernel."""
    one, x = np.float32(1.0), np.float32(-dt) / np.float32(tau)
    return float(one - np.exp(x))


def _check_part(part: str):
    if part not in PARTS:
        raise ValueError(f"part {part!r}: expected one of {PARTS}")


def _count(fn, part: str, masked: bool, epilogue: bool = False):
    if part != "grid":
        name = f"{part}_launches"
    elif epilogue:
        name = "epilogue_launches"
    else:
        name = "masked_launches" if masked else "launches"
    setattr(fn, name, getattr(fn, name) + 1)


def predictor(ev: State, grid: Grid, forcing: Forcing, dt: float, *,
              with_rad: bool, with_diff: bool, vmask=None,
              part: str = "grid") -> State:
    """Matsuno predictor substep (tendencies at ``ev``, advanced from it).
    ``vmask``: the v wall as a (ny,) row mask (``wall_mask``) instead of
    the row index. ``part`` names what the block is, for the launch
    counters: ``"grid"``, ``"shard"``, ``"south_strip"`` or
    ``"north_strip"``."""
    _check_part(part)
    _validate(ev, None, grid, forcing, with_rad, vmask=vmask)
    if ev.u.device.type == "cpu":
        return fused_substep_plain(ev, None, grid, forcing, dt,
                                   with_rad=with_rad, with_diff=with_diff,
                                   vmask=vmask)
    out = _launch(ev, None, grid, forcing, dt, with_rad, with_diff, None,
                  vmask)
    _count(predictor, part, vmask is not None)
    return out


def corrector(ev: State, base: State, grid: Grid, forcing: Forcing,
              dt: float, *, with_rad: bool, with_diff: bool,
              phys: tuple | None = None, vmask=None,
              part: str = "grid") -> State:
    """Matsuno corrector substep (tendencies at the predicted ``ev``,
    advanced from the time-n ``base``). ``phys`` (``model.py::
    phys_epilogue_tuple``) adds the physics epilogue; ``vmask`` and
    ``part`` as for the predictor."""
    _check_part(part)
    _validate(ev, base, grid, forcing, with_rad, phys, vmask)
    if ev.u.device.type == "cpu":
        return fused_substep_plain(ev, base, grid, forcing, dt,
                                   with_rad=with_rad, with_diff=with_diff,
                                   phys=phys, vmask=vmask)
    out = _launch(ev, base, grid, forcing, dt, with_rad, with_diff, phys,
                  vmask)
    _count(corrector, part, vmask is not None, epilogue=phys is not None)
    return out


def reset_launch_counts():
    """Set every launch counter of the substep kernels to 0."""
    for fn in (predictor, corrector):
        for name in ("launches", "masked_launches", "shard_launches",
                     "south_strip_launches", "north_strip_launches"):
            setattr(fn, name, 0)
    corrector.epilogue_launches = 0


reset_launch_counts()
