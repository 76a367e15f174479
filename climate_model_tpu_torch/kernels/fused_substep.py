"""Fused dycore substep: the hand-written CUDA kernel, its wrappers and its
plain PyTorch version.

Port of the two variants of ``climate_model_tpu/kernels/fused_substep.py::
make_fused_substep_packed`` that the per-step Matsuno path launches: the
predictor (``same_base=True``) and the corrector (``same_base=False``), both
with the radiative source and horizontal diffusion compiled in or out by a
launch argument. The kernel source is ``csrc/fused_substep.cu``; its header
says how it is split into launches and what bounds it on the card.

* ``predictor`` / ``corrector`` are the wrappers. On a CUDA tensor they
  launch the kernel (fp32 only) or raise; on a CPU tensor they call the plain
  version. Each counts its launches in a plain integer attribute
  ``.launches``.
* ``fused_substep_plain`` is the port's own plain substep (``tendencies``
  followed by ``proceed``): exactly what the kernel computes. The CPU tests use it, and
  ``chip_smoke.py`` holds the kernel against it on the card.

The library is built at first use with one ``nvcc`` call over every
``csrc/*.cu`` into ``climate_model_tpu_torch/_build/`` (named by a hash of
the sources, so an edit rebuilds) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 26 + [_I] * 3 + [_F] * 3 + [_I] * 3 + [_P]


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
    for s in sources:
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
        fn = lib.cm_fused_substep_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


def geo_table(grid: Grid) -> torch.Tensor:
    """The per-latitude geometry as one contiguous (ny, 11) table in
    ``GEO_FIELDS`` order (what the kernel reads)."""
    return torch.stack([getattr(grid, f) for f in GEO_FIELDS], dim=1)


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


def fused_substep_plain(ev: State, base: State | None, grid: Grid,
                        forcing: Forcing, dt: float, *, with_rad: bool,
                        with_diff: bool) -> State:
    """One substep in plain PyTorch (the stepper's ``substep`` with the
    kernel's terms): tendencies at ``ev`` advanced from ``base``
    (``base=None``: from ``ev``, the predictor). Returns ``base`` with u, v,
    pott, qv, qc and colp replaced."""
    from ..dycore.stepper import substep
    return substep(ev, ev if base is None else base, dt, grid, forcing,
                   _plain_cfg(with_rad, with_diff))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_FIELDS3 = ("u", "v", "pott", "qv", "qc")


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
              with_rad: bool):
    """Device, dtype, shape and contiguity of every tensor the kernel
    reads. On the card the dtype must be float32 (the kernel's only type);
    on the CPU every tensor must share the dtype of ``ev.u``."""
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


def _launch(ev: State, base: State | None, grid: Grid, forcing: Forcing,
            dt: float, with_rad: bool, with_diff: bool) -> State:
    dev = ev.u.device
    nz, ny, nx = ev.u.shape
    s3 = (nz, ny, nx)
    b = ev if base is None else base
    geo = geo_table(grid)
    out = {f: torch.empty(s3, dtype=torch.float32, device=dev)
           for f in _FIELDS3}
    colp = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    wwind = torch.empty((nz + 1, ny, nx), dtype=torch.float32, device=dev)
    phi = torch.empty(s3, dtype=torch.float32, device=dev)
    pvtf = torch.empty(s3, dtype=torch.float32, device=dev)
    rad_ptr = ev.dpottdt_rad.data_ptr() if with_rad else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cm_fused_substep_f32(
            *(getattr(ev, f).data_ptr() for f in _FIELDS3), ev.colp.data_ptr(),
            *(getattr(b, f).data_ptr() for f in _FIELDS3), b.colp.data_ptr(),
            forcing.hsurf.data_ptr(), rad_ptr, geo.data_ptr(),
            grid.sigma_vb.data_ptr(), grid.dsigma.data_ptr(),
            *(out[f].data_ptr() for f in _FIELDS3), colp.data_ptr(),
            wwind.data_ptr(), phi.data_ptr(), pvtf.data_ptr(),
            nz, ny, nx, float(dt), float(grid.dy), float(grid.ptop),
            int(base is None), int(with_rad), int(with_diff), stream)
    if err != 0:
        raise RuntimeError(f"fused_substep launch failed: CUDA error {err}")
    return b.replace(colp=colp, **out)


def predictor(ev: State, grid: Grid, forcing: Forcing, dt: float, *,
              with_rad: bool, with_diff: bool) -> State:
    """Matsuno predictor substep (tendencies at ``ev``, advanced from it)."""
    _validate(ev, None, grid, forcing, with_rad)
    if ev.u.device.type == "cpu":
        return fused_substep_plain(ev, None, grid, forcing, dt,
                                   with_rad=with_rad, with_diff=with_diff)
    out = _launch(ev, None, grid, forcing, dt, with_rad, with_diff)
    predictor.launches += 1
    return out


def corrector(ev: State, base: State, grid: Grid, forcing: Forcing,
              dt: float, *, with_rad: bool, with_diff: bool) -> State:
    """Matsuno corrector substep (tendencies at the predicted ``ev``,
    advanced from the time-n ``base``)."""
    _validate(ev, base, grid, forcing, with_rad)
    if ev.u.device.type == "cpu":
        return fused_substep_plain(ev, base, grid, forcing, dt,
                                   with_rad=with_rad, with_diff=with_diff)
    out = _launch(ev, base, grid, forcing, dt, with_rad, with_diff)
    corrector.launches += 1
    return out


predictor.launches = 0
corrector.launches = 0
