"""The port stands alone, and its kernel wrapper routes and refuses inputs.

* Every module of ``climate_model_tpu_torch`` (``dist/`` included) and
  ``chip_smoke`` imports in a process where ``jax`` cannot be imported, and
  loads no module of the JAX package.
* The substep wrappers check device, dtype, shape and contiguity, the
  physics-epilogue tuple and the wall mask, and take the plain version for
  CPU tensors; with the single-device mask the plain version equals the
  index rule bit for bit.
* On a card (tests marked ``gpu``, which skip without one) the kernels agree
  with the plain version: the substep at a small size, the corrector with
  the physics epilogue at config #3 and on a 96-level column, and the
  shard-local and seam-strip variants on blocks of a #4 state, with
  ``chip_smoke.py``'s bounds.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import climate_model_tpu_torch
from climate_model_tpu_torch.core.config import (GridConfig, ModelConfig,
                                                 PhysicsConfig)
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.kernels import fused_substep as fs

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = [climate_model_tpu_torch.__name__]
    for m in pkgutil.walk_packages(climate_model_tpu_torch.__path__,
                                   climate_model_tpu_torch.__name__ + "."):
        names.append(m.name)
    return names


def test_port_imports_without_jax():
    mods = _port_modules()
    for name in ("kernels.fused_substep", "dist.mesh", "dist.sharding",
                 "dist.comm", "dist.packed_halo", "core.namelist",
                 "io.checkpoint", "io.netcdf", "io.topo", "io.plot"):
        assert f"climate_model_tpu_torch.{name}" in mods, name
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'climate_model_tpu'\n"
        "             or m.startswith('climate_model_tpu.')\n"
        "             or m == 'jax' and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def _small(dtype="float64", device="cpu"):
    cfg = ModelConfig(grid=GridConfig(nx=16, ny=10, nz=4), dtype=dtype)
    st, fo, gr = initialize(cfg, device=device)
    r = np.random.default_rng(5)
    noise = torch.as_tensor(r.normal(0, 1.0, st.u.shape), dtype=st.dtype,
                            device=st.device)
    return st.replace(u=st.u + noise), fo, gr


KW = dict(with_rad=True, with_diff=True)


def test_wrapper_cpu_routes_to_plain():
    st, fo, gr = _small()
    out = fs.predictor(st, gr, fo, gr.dt, **KW)
    ref = fs.fused_substep_plain(st, None, gr, fo, gr.dt, **KW)
    for f in ("u", "v", "pott", "qv", "qc", "colp"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    out = fs.corrector(ref, st, gr, fo, gr.dt, **KW)
    want = fs.fused_substep_plain(ref, st, gr, fo, gr.dt, **KW)
    for f in ("u", "v", "pott", "qv", "qc", "colp"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert fs.predictor.launches == 0 and fs.corrector.launches == 0


@pytest.mark.parametrize("bad,err,match", [
    (lambda s: s.replace(v=s.v.float()), TypeError, "ev.v: dtype"),
    (lambda s: s.replace(qv=s.qv[:, :, :-1]), ValueError, "ev.qv: shape"),
    (lambda s: s.replace(pott=s.pott.transpose(1, 2).contiguous()
                         .transpose(1, 2)), ValueError, "pott: not contig"),
    (lambda s: s.replace(colp=s.colp[None]), ValueError, "ev.colp: shape"),
    (lambda s: s.replace(dpottdt_rad=s.dpottdt_rad[::2]), ValueError,
     "dpottdt_rad: shape"),
])
def test_wrapper_refuses_bad_inputs(bad, err, match):
    st, fo, gr = _small()
    with pytest.raises(err, match=match):
        fs.predictor(bad(st), gr, fo, gr.dt, **KW)
    with pytest.raises(err, match=match.replace("ev.", "base.")
                       if "dpottdt" not in match else match):
        if "dpottdt" in match:
            fs.corrector(bad(st), st, gr, fo, gr.dt, **KW)
        else:
            fs.corrector(st, bad(st), gr, fo, gr.dt, **KW)


def _phys():
    from climate_model_tpu_torch.model import phys_epilogue_tuple
    cfg = ModelConfig(physics=PhysicsConfig(surface=True, turbulence=True,
                                            microphysics=True))
    return phys_epilogue_tuple(cfg)


@pytest.mark.parametrize("bad,err,match", [
    (lambda s, f, m, p: (s, f, m, p[:-1]), ValueError, "phys: expected"),
    (lambda s, f, m, p: (s, f, m, list(p)), ValueError, "phys: expected"),
    (lambda s, f, m, p: (s, f, torch.ones(len(m) + 1, dtype=m.dtype), p),
     ValueError, "vmask: shape"),
    (lambda s, f, m, p: (s, f, m.float(), p), TypeError, "vmask: dtype"),
    (lambda s, f, m, p: (s, f, torch.empty(m.shape, dtype=m.dtype,
                                           device="meta"), p),
     ValueError, "vmask: on meta"),
    (lambda s, f, m, p: (s.replace(tsurf=s.tsurf[:-1]), f, m, p), ValueError,
     "base.tsurf: shape"),
    (lambda s, f, m, p: (s.replace(lwflx_sfc=s.lwflx_sfc.float()), f, m, p),
     TypeError, "base.lwflx_sfc: dtype"),
    (lambda s, f, m, p: (s, f.__class__(**{**f.__dict__, "land_mask":
                                            f.land_mask.float()}), m, p),
     TypeError, "forcing.land_mask: dtype"),
])
def test_wrapper_refuses_bad_phys_and_mask(bad, err, match):
    st, fo, gr = _small()
    mask = fs.wall_mask(gr.ny, st.dtype, "cpu")
    base, forcing, vmask, phys = bad(st, fo, mask, _phys())
    with pytest.raises(err, match=match):
        fs.corrector(st, base, gr, forcing, gr.dt, phys=phys, vmask=vmask,
                     **KW)
    if "vmask" in match:
        with pytest.raises(err, match=match):
            fs.predictor(st, gr, fo, gr.dt, vmask=vmask, **KW)


def test_default_mask_equals_index_rule():
    """With the single-device wall mask, the plain predictor and the plain
    corrector with and without the epilogue equal the index rule bit for
    bit; a mask with an interior row set to 0 zeroes v on it."""
    st, fo, gr = _small()
    mask = fs.wall_mask(gr.ny, st.dtype, "cpu")
    assert mask.tolist() == [0.0] + [1.0] * (gr.ny - 1)
    fields = ("u", "v", "pott", "qv", "qc", "colp", "tsurf", "rain",
              "soil_moist")
    pred = fs.predictor(st, gr, fo, gr.dt, **KW)
    pred_m = fs.predictor(st, gr, fo, gr.dt, vmask=mask, **KW)
    for phys in (None, _phys()):
        corr = fs.corrector(pred, st, gr, fo, gr.dt, phys=phys, **KW)
        corr_m = fs.corrector(pred_m, st, gr, fo, gr.dt, phys=phys,
                              vmask=mask, **KW)
        for a, b in ((pred, pred_m), (corr, corr_m)):
            for f in fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
    holed = mask.clone()
    holed[4] = 0.0
    out = fs.corrector(pred, st, gr, fo, gr.dt, phys=_phys(), vmask=holed,
                       **KW)
    assert float(out.v[:, 4].abs().max()) == 0.0
    assert float(out.v[:, 5].abs().max()) > 0.0


def test_wrapper_refuses_other_devices():
    st, fo, gr = _small()
    meta = st.replace(u=torch.empty(st.u.shape, dtype=st.dtype,
                                    device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.predictor(meta, gr, fo, gr.dt, **KW)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the substep kernel is CUDA C++ "
                    "with no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device):
    st, fo, gr = _small(dtype="float32", device=cuda_device)
    p0, c0 = fs.predictor.launches, fs.corrector.launches
    pk = fs.predictor(st, gr, fo, gr.dt, **KW)
    pp = fs.fused_substep_plain(st, None, gr, fo, gr.dt, **KW)
    ck = fs.corrector(pp, st, gr, fo, gr.dt, **KW)
    cp = fs.fused_substep_plain(pp, st, gr, fo, gr.dt, **KW)
    torch.cuda.synchronize()
    assert (fs.predictor.launches - p0, fs.corrector.launches - c0) == (1, 1)
    # the per-field bounds of chip_smoke.py (a few times the fp32 error
    # measured at config #3)
    from chip_smoke import FIELD_TOL
    for got, want in ((pk, pp), (ck, cp)):
        for f, bound in FIELD_TOL.items():
            a, b = getattr(got, f), getattr(want, f)
            assert bool(torch.isfinite(a).all()), f
            assert float((a - b).abs().max()) <= bound, f


@pytest.mark.gpu
def test_epilogue_kernel_matches_plain_on_card(cuda_device):
    """The corrector with the physics epilogue (and the masked predictor)
    against their plain versions at config #3, from ``chip_smoke.py``'s
    moist check state, within its bounds; the mask equals the index rule
    bit for bit."""
    import chip_smoke as cs
    ci = cs.check_inputs(cuda_device)
    kern, plain = cs.epilogue_pair(ci)
    e0 = fs.corrector.epilogue_launches
    got, want = kern(), plain()
    torch.cuda.synchronize()
    assert fs.corrector.epilogue_launches - e0 == 1
    per = cs.field_errors(got, want, cs.EPI_TOL)
    assert not cs.over(per, cs.EPI_TOL), per
    g, f, s = ci.grid, ci.forcing, ci.state
    assert cs.bitwise_equal(fs.predictor(s, g, f, g.dt, **ci.kw),
                            fs.predictor(s, g, f, g.dt, vmask=ci.vmask,
                                         **ci.kw))


@pytest.mark.gpu
def test_kernel_refuses_float64_on_card(cuda_device):
    st, fo, gr = _small(dtype="float64", device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        fs.predictor(st, gr, fo, gr.dt, **KW)


@pytest.mark.gpu
def test_tall_epilogue_matches_plain_on_card(cuda_device):
    """The corrector with the physics epilogue on 96-level columns (three
    levels a lane of the epilogue's warps) within ``chip_smoke.py``'s
    bounds."""
    import chip_smoke as cs
    bad = []
    cs.check_tall(cuda_device, bad)
    assert not bad, bad


@pytest.mark.gpu
def test_shard_kernels_match_plain_on_card(cuda_device):
    """The shard-local and seam-strip variants against their plain versions
    on ``chip_smoke.py``'s check blocks of a noisy #4 state (interior,
    polar-edge and lon-seam shards), over the interior they keep, within
    its bounds (pinned for that state); each call counts once."""
    import chip_smoke as cs

    fs.reset_launch_counts()
    bad = []
    _, (blocks, _, _, _) = cs.check_shards(cs.noisy4(cuda_device),
                                           cuda_device, bad)
    torch.cuda.synchronize()
    assert not bad, bad
    for fn in (fs.predictor, fs.corrector):
        assert fn.shard_launches == len(blocks)
        for part in ("south_strip", "north_strip"):
            want = sum(st.part == part for b in blocks for st in b.strips)
            assert getattr(fn, f"{part}_launches") == want, part
        assert fn.launches == fn.masked_launches == 0
