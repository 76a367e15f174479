"""The port stands alone, and its kernel wrapper routes and refuses inputs.

* Every module of ``climate_model_tpu_torch`` and ``chip_smoke`` imports in a
  process where ``jax`` cannot be imported, and loads no module of the JAX
  package.
* The substep wrappers check device, dtype, shape and contiguity, and take
  the plain version for CPU tensors.
* On a card (tests marked ``gpu``, which skip without one) the kernels agree
  with the plain version at a small size.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import climate_model_tpu_torch
from climate_model_tpu_torch.core.config import GridConfig, ModelConfig
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.kernels import fused_substep as fs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = [climate_model_tpu_torch.__name__]
    for m in pkgutil.walk_packages(climate_model_tpu_torch.__path__,
                                   climate_model_tpu_torch.__name__ + "."):
        names.append(m.name)
    return names


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "climate_model_tpu_torch.kernels.fused_substep" in mods
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
def test_kernel_refuses_float64_on_card(cuda_device):
    st, fo, gr = _small(dtype="float64", device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        fs.predictor(st, gr, fo, gr.dt, **KW)
