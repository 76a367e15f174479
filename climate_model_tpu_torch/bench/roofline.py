"""Roofline model of the card: the byte model of a step, the card's peaks
and the least time of one substep call.

Port of ``climate_model_tpu/bench/roofline.py``. The byte model
(``step_bytes_per_point``, ``speed_of_light_gps``) is the reference's: it
counts the field traversals a step needs under perfect fusion, which does
not depend on the device. The peaks are the card's own (NVIDIA's data
sheets: HBM bandwidth and float32 outside the tensor cores). A CUDA card
not in the table raises: a roofline share against a guessed peak would be
a wrong number that looks right. ``cpu`` carries rough single-socket
figures for sanity runs of the plain versions, never a device metric.

The reference's second half (a VPU element rate and the element count of
a traced Mosaic kernel) has no counterpart on the card; the share of the
card's fp32 peak (``step_kernel_flops_per_point``) takes its place.

``substep_work`` counts one substep call's bytes (each input read once,
each output written once) and operations; ``substep_bound_ms``, the larger
of the two over the card's rates, is the bound of every kernel in
``chip_smoke.py``, and the bytes over the memory rate are the byte floors
of ``bench --micro``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
CPU_PEAKS = Peaks(5.0e10, 1.0e12)   # rough single-socket figures (sanity)

# Floating-point operations per grid point, rounded up (an upper count:
# the bound is the bytes' at every shape the port runs). Substep: column
# scans incl. one powf per level ~35, three scalar advections ~135, two
# momentum equations ~140, face fluxes ~40. Epilogue (counting powf and
# expf as 20): up to three column profiles ~180, the five diffusions ~50,
# two face profiles ~16, microphysics ~80, the surface of three columns
# spread over the levels ~10, convective K (when on) ~70 -> 350 with it off.
FLOPS_PER_POINT = 350
EPILOGUE_FLOPS_PER_POINT = 350


def card_name(device) -> str:
    """The name the peaks are looked up by: the CUDA device's name, or
    ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    if dev.type == "cpu":
        return "cpu"
    raise ValueError(f"no peaks for device type {dev.type!r}")


def peaks(name: str) -> Peaks:
    """The peaks of the card named ``name`` (``card_name``). Raises on a
    card the table does not hold."""
    if name == "cpu":
        return CPU_PEAKS
    for key, pk in PEAKS:
        if key in name:
            return pk
    raise ValueError(f"no peaks known for the card {name!r}; add its data "
                     f"sheet's rates to bench/roofline.py::PEAKS "
                     f"(known: {[k for k, _ in PEAKS]})")


def device_hbm_bw(device) -> float:
    return peaks(card_name(device)).bytes_per_s


def device_fp32_peak(device) -> float:
    return peaks(card_name(device)).fp32_flops


def step_bytes_per_point(nz: int, dtype_bytes: int = 4,
                         stepper: str = "matsuno",
                         physics: bool = False,
                         rad_every_steps: int = 6) -> float:
    """Minimum memory traffic per grid point per full model step.

    Counting unique (nz,ny,nx)-array traversals for ONE tendency+update pass
    assuming perfect fusion (each array read once, written once):

      reads:  u, v, pott, qv, qc            (5 prognostics)
              + colp-derived 2-D fields     (~0 per point, 1/nz each)
      intermediates that must round-trip memory under perfect fusion:
      none (phi/pvtf/fluxes/wwind are recomputed per tile).
      writes: u, v, pott, qv, qc            (5)

    => 10 traversals per pass. Matsuno does 2 passes; the corrector
    additionally re-reads the ORIGINAL (t_n) state for its mass-weighted
    update (+5): 25 traversals.

    Full physics (the epilogue schedule, all four parameterizations):
      + cached radiative heating read by both substeps' POTT tendency (+2)
      + surface/turbulence/microphysics consume the corrector's updated
        fields (0 extra traversals: that is the point of the epilogue) but
        tsurf/rain round-trip as 2-D fields (~0)
      + the radiation recompute itself reads pott/qv/qc + writes the nz
        heating cache (~4 traversals) every ``rad_every_steps`` steps.
    """
    passes = {"euler": 10, "matsuno": 25, "rk4": 45}[stepper]
    if physics:
        passes += 2 + 4.0 / max(rad_every_steps, 1)
    return passes * dtype_bytes


def speed_of_light_gps(device, nz: int, dtype_bytes=4, stepper="matsuno",
                       physics=False, rad_every_steps=6) -> float:
    """Speed-of-light grid-points/s for a full model step on ``device``."""
    bw = device_hbm_bw(device)
    return bw / step_bytes_per_point(nz, dtype_bytes, stepper, physics,
                                     rad_every_steps)


def step_kernel_flops_per_point(with_phys: bool) -> int:
    """Operations per grid point of one packed-scan step's two kernels: the
    predictor, and the corrector with the epilogue when ``with_phys``."""
    return 2 * FLOPS_PER_POINT + (EPILOGUE_FLOPS_PER_POINT if with_phys
                                  else 0)


def substep_work(ev, base, grid, forcing, out, phys=None, vmask=None,
                 ) -> tuple:
    """(bytes, operations) of one substep call: each tensor the kernel
    reads counted once, each it writes once; the operations at
    ``FLOPS_PER_POINT`` (+ ``EPILOGUE_FLOPS_PER_POINT`` with ``phys``) a
    grid point. ``base`` is None for the predictor."""
    from ..kernels.fused_substep import geo_table
    reads = [getattr(ev, f) for f in ("u", "v", "pott", "qv", "qc", "colp",
                                      "dpottdt_rad")]
    if base is not None:
        reads += [getattr(base, f) for f in ("u", "v", "pott", "qv", "qc",
                                             "colp")]
    reads += [forcing.hsurf, geo_table(grid), grid.sigma_vb, grid.dsigma]
    writes = [getattr(out, f) for f in ("u", "v", "pott", "qv", "qc", "colp")]
    flops = FLOPS_PER_POINT
    if vmask is not None:
        reads.append(vmask)
    if phys is not None:
        reads += [getattr(base, f) for f in ("tsurf", "rain", "soil_moist",
                                             "swflx_sfc", "lwflx_sfc")]
        reads += [forcing.land_mask, forcing.evap_eff]
        writes += [out.tsurf, out.rain, out.soil_moist]
        flops += EPILOGUE_FLOPS_PER_POINT
    n_bytes = sum(t.numel() * t.element_size() for t in reads + writes)
    return n_bytes, flops * ev.u.numel()


def substep_bound_ms(ev, base, grid, forcing, out, phys=None, vmask=None
                     ) -> tuple:
    """(ms, what bounds it): the least time for one substep call on the
    device of ``ev``, the larger of its bytes over the memory rate and its
    operations over the fp32 rate (``substep_work``)."""
    pk = peaks(card_name(ev.u.device))
    n_bytes, flops = substep_work(ev, base, grid, forcing, out, phys, vmask)
    t_bytes = n_bytes / pk.bytes_per_s
    t_ops = flops / pk.fp32_flops
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"
