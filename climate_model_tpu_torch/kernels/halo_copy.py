"""The ghost exchange's batched slab copy: many strided slabs in one launch.

``copy_slabs(pairs)`` copies each ``(dst, src)`` pair of same-shaped views
of at most 3 dims, of a dtype whose size is a multiple of 4 bytes, that
the kernel's descriptor reaches (two strided dims over a contiguous run,
``slab``). The exchange (``dist/comm.py``) packs, and unpacks,
every slab of an exchange with one call, the seam strips
(``dist/packed_halo.py``) cut and splice every field of a strip with one.

* On a CUDA tensor: ``slab_copy_kernel`` (``csrc/halo_copy.cu``, whose
  header gives the design and the bound), one launch for up to
  ``MAX_SLABS`` pairs, its descriptors (``plan``) passed by value in the
  kernel's parameters, so a captured graph replays the same launch. Each
  launch moves the counters ``halo_copy.launches`` and ``halo_copy.slabs``
  (``trace.py``).
* On a CPU tensor: the plain version, a ``copy_`` a pair, in order; it
  counts nothing, as the kernel wrappers' plain versions count nothing.

The pairs of one call must not overlap: the kernel copies them in no
order. A copy is exact, so the two versions write the same bits.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..trace import count
from .fused_substep import _lib

MAX_SLABS = 48          # descriptors a launch (kMaxSlabs)
THREADS = 256           # a block's threads (kThreads)
WIDE_WORDS = 32         # words a line from which a warp takes it (kWide)
SEG_WORDS = 1024        # words a warp's unit, at most (kSeg)
PARAM_BYTES = 4096      # the kernel parameters' limit on every CUDA version

# one descriptor, as ``Slab`` of csrc/halo_copy.cu: pointers, the strides of
# levels and rows (source, destination) and the extents in 32-bit words,
# and the slab's first grid block
SLAB = np.dtype([("src", "<u8"), ("dst", "<u8"), ("sz", "<i8"),
                 ("sr", "<i8"), ("dz", "<i8"), ("dr", "<i8"),
                 ("nz", "<i4"), ("rows", "<i4"), ("cols", "<i4"),
                 ("block0", "<i4")])


def slab(dst: torch.Tensor, src: torch.Tensor) -> tuple:
    """The descriptor of copying ``src`` into ``dst``, without its block0:
    ``(src, dst, sz, sr, dz, dr, nz, rows, cols)`` in 32-bit words, rows
    and then levels merged into the run where both sides are contiguous
    across them. Raises on what the kernel does not take."""
    if dst.shape != src.shape or dst.dtype != src.dtype \
            or dst.device != src.device:
        raise ValueError(f"a slab pair differs: {tuple(dst.shape)} "
                         f"{dst.dtype} {dst.device} <- {tuple(src.shape)} "
                         f"{src.dtype} {src.device}")
    size = dst.element_size()
    if dst.dim() > 3 or size % 4:
        raise ValueError(f"a slab of {dst.dim()} dims of {size}-byte "
                         "elements: at most 3 dims of a multiple of 4 bytes")
    # (extent, source stride, destination stride), outermost first; a dim
    # joins the one outside it where both sides step over it contiguously,
    # and the innermost group is the run, of stride 1 (extent 1 if need be)
    groups = []
    for n, s, d in zip(dst.shape, src.stride(), dst.stride()):
        if n == 1:
            continue
        if groups and groups[-1][1:] == (n * s, n * d):
            groups[-1] = (groups[-1][0] * n, s, d)
        else:
            groups.append((n, s, d))
    if not groups or groups[-1][1:] != (1, 1):
        groups.append((1, 1, 1))
    if len(groups) > 3:
        raise ValueError(f"a slab's last dim is not contiguous: strides "
                         f"{src.stride()} -> {dst.stride()}")
    if dst.data_ptr() % 4 or src.data_ptr() % 4:
        raise ValueError("a slab not aligned to 4 bytes")
    (nz, sz, dz), (rows, sr, dr), (cols, _, _) = \
        [(1, 0, 0)] * (3 - len(groups)) + groups
    w = size // 4
    return (src.data_ptr(), dst.data_ptr(), sz * w, sr * w, dz * w, dr * w,
            nz, rows, cols * w)


def blocks(nz: int, rows: int, cols: int) -> int:
    """The grid blocks of a slab of ``nz`` x ``rows`` lines of ``cols``
    words, as the kernel cuts it: a warp a unit of a line and at most
    SEG_WORDS words where a line has WIDE_WORDS or more, else a thread a
    line."""
    lines = nz * rows
    if cols >= WIDE_WORDS:
        units = lines * -(-cols // SEG_WORDS)
        return -(-units // (THREADS // 32))
    return -(-lines // THREADS)


def plan(pairs: list) -> list:
    """The launches that copy ``pairs`` (none empty), in order: for each,
    its descriptors (a ``SLAB`` array of at most MAX_SLABS, block0 the
    prefix of the slabs' blocks) and its grid's blocks."""
    out = []
    for i in range(0, len(pairs), MAX_SLABS):
        rows, block0 = [], 0
        for d, s in pairs[i:i + MAX_SLABS]:
            x = slab(d, s)
            rows.append(x + (block0,))
            block0 += blocks(*x[6:])
        out.append((np.array(rows, dtype=SLAB), block0))
    return out


@functools.cache
def _kernel_lib():
    """The kernel library, once its descriptor layout is checked against
    this module's."""
    lib = _lib()
    got = (ctypes.c_int * 5)()
    lib.cm_slab_copy_layout(got)
    want = (SLAB.itemsize, MAX_SLABS, THREADS, WIDE_WORDS, SEG_WORDS)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/halo_copy.cu lays out {tuple(got)}, "
                           f"halo_copy.py {want}")
    return lib


def copy_slabs(pairs):
    """Copy each ``(dst, src)`` of ``pairs``: on the card one launch for
    every MAX_SLABS pairs, on the CPU a ``copy_`` each."""
    pairs = [(d, s) for d, s in pairs if d.numel()]
    if not pairs:
        return
    dev = pairs[0][0].device
    if not _on_card(dev):
        for d, s in pairs:
            d.copy_(s)
        return
    if any(d.device != dev for d, _ in pairs):
        raise ValueError("slab pairs on more than one device")
    for descs, n in plan(pairs):
        _launch(descs, n, dev)
        count("halo_copy.launches")
        count("halo_copy.slabs", len(descs))


def _on_card(dev: torch.device) -> bool:
    """Whether tensors on ``dev`` take the kernel (the CPU tests put an
    emulation of it in ``_launch``)."""
    return dev.type == "cuda"


def _launch(descs: np.ndarray, n: int, dev: torch.device):
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.cm_slab_copy(descs.ctypes.data, len(descs), n,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slab copy launch failed: CUDA error {err}")
