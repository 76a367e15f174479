"""The port's io layer against the JAX reference, through files (CPU).

* Checkpoints: the reference writes and the port reads, and the other way,
  bit for bit at fp32 and fp64; the two packages write the same file for
  the same state. Identity records, fingerprints and mismatch records are
  equal for BASELINE 1-5 and every ``configs/*.toml``; the tracked
  checkpoints of the reference load bit for bit, and the legacy one is
  refused.
* NetCDF: the same state through both writers, every variable within one
  fp32 ulp (both compute in fp64 and cast: ``rtol=2.4e-7``, with an ``atol``
  of 1e-9 times the field's largest magnitude for values near zero).
* Metrics JSONL, topography and TOML namelists: equal keys, arrays and
  configs.
* Quicklook plots render (where ``matplotlib`` is installed).
* On the card (marked ``gpu``, skipped without one): a checkpoint saved
  from the card and loaded back to it, bit for bit.

Grids are 16x10x4 fp64 unless the point is a file's real shape.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from climate_model_tpu_torch.core import config as tcfg
from climate_model_tpu_torch.core import init as tinit
from climate_model_tpu_torch.core import namelist as tnamelist
from climate_model_tpu_torch.core.grid import make_grid
from climate_model_tpu_torch.io import checkpoint as tckpt
from climate_model_tpu_torch.io import convert
from climate_model_tpu_torch.io import metrics as tmetrics
from climate_model_tpu_torch.io import netcdf as tnc
from climate_model_tpu_torch.io import topo as ttopo

try:
    import jax.numpy as jnp

    from climate_model_tpu.core import config as jcfg
    from climate_model_tpu.core import grid as jgrid
    from climate_model_tpu.core import init as jinit
    from climate_model_tpu.core import namelist as jnamelist
    from climate_model_tpu.core.state import Forcing as JForcing
    from climate_model_tpu.core.state import State as JState
    from climate_model_tpu.io import checkpoint as jckpt
    from climate_model_tpu.io import metrics as jmetrics
    from climate_model_tpu.io import netcdf as jnc
    from climate_model_tpu.io import topo as jtopo

    from .test_torch_core import jax_cfg, jax_inputs, port_inputs
except ImportError:
    # The card's machine has no JAX; there the module runs only its gpu
    # test (``-m gpu``), which needs nothing of the reference.
    pass

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.toml")))
TRACKED = ("out_clim_continents", "out_winter", "out_annual_continents")
STATE_FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
                "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc", "t",
                "step")


def io_cfg(nx=16, ny=10, nz=4, **kw):
    return tcfg.ModelConfig(grid=tcfg.GridConfig(nx=nx, ny=ny, nz=nz),
                            **{"dtype": "float64", **kw})


def state_np(dtype, seed=3) -> dict:
    """A perturbed 16x10x4 state as NumPy arrays at ``dtype``, at step 7."""
    st, _, _ = jax_inputs(io_cfg(), seed=seed)
    out = {k: np.asarray(v, dtype) for k, v in st.items()}
    out["t"] = np.asarray(7 * 1309.7, dtype)
    out["step"] = np.asarray(7, np.int32)
    return out


def jax_state(d: dict) -> "JState":
    return JState(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_state_equal(port_state, ref: dict):
    for name in STATE_FIELDS:
        got = getattr(port_state, name)
        want = np.asarray(ref[name])
        if name == "step":
            assert got == int(want)
            continue
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def npz_items(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_checkpoint_reference_to_port(dtype, tmp_path):
    d = state_np(dtype)
    cfg = io_cfg(dtype=np.dtype(dtype).name)
    path = str(tmp_path / "restart.npz")
    jckpt.save_checkpoint(path, jax_state(d), jax_cfg(cfg))
    st, mismatch = tckpt.load_checkpoint_ex(path, cfg, device="cpu")
    assert mismatch is None
    assert_state_equal(st, d)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_checkpoint_port_to_reference(dtype, tmp_path):
    """The port's file reads bit for bit in the reference, and equals the
    file the reference writes for the same state, key by key (identity
    record included)."""
    d = state_np(dtype)
    cfg = io_cfg(dtype=np.dtype(dtype).name)
    port_path, ref_path = str(tmp_path / "p.npz"), str(tmp_path / "r.npz")
    kw = dict(device="cpu", dtype=getattr(torch, np.dtype(dtype).name))
    tckpt.save_checkpoint(port_path, convert.state_from_numpy(d, **kw), cfg)
    st, mismatch = jckpt.load_checkpoint_ex(port_path, jax_cfg(cfg))
    assert mismatch is None
    for name in STATE_FIELDS:
        got = np.asarray(getattr(st, name))
        assert got.dtype == d[name].dtype, name
        np.testing.assert_array_equal(got, d[name], err_msg=name)
    jckpt.save_checkpoint(ref_path, jax_state(d), jax_cfg(cfg))
    mine, theirs = npz_items(port_path), npz_items(ref_path)
    assert list(mine) == list(theirs)
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


CONFIGS = [f"baseline_{n}" for n in range(1, 6)] \
    + [os.path.basename(p) for p in TOMLS]


@pytest.mark.parametrize("name", CONFIGS)
def test_identity_records_equal(name):
    if not name.endswith(".toml"):
        n = int(name.split("_")[1])
        port, ref = tcfg.baseline_config(n), jcfg.baseline_config(n)
    else:
        path = os.path.join(ROOT, "configs", name)
        port, ref = tnamelist.load_config(path), jnamelist.load_config(path)
    a, b = tckpt.config_identity(port), jckpt.config_identity(ref)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert tckpt.config_fingerprint(port) == jckpt.config_fingerprint(ref)


def test_checkpoint_mismatch_and_force(tmp_path):
    """As the reference's ``test_checkpoint_resume_across_run_settings``:
    run length, cadence, backend and mesh are not identity; a retuned
    diffusion is refused naming the field, and ``force=True`` loads the
    same bytes and returns the reference's mismatch record."""
    d = state_np(np.float64)
    cfg = io_cfg()
    path = str(tmp_path / "restart.npz")
    tckpt.save_checkpoint(path, convert.state_from_numpy(
        d, device="cpu", dtype=torch.float64), cfg)
    extended = cfg.replace(
        sim_days=cfg.sim_days * 8, out_every_hours=1.0, backend="pallas",
        sharding=tcfg.ShardingConfig(mesh_lat=2, mesh_lon=4,
                                     mode="shard_map"))
    assert tckpt.config_fingerprint(extended) == tckpt.config_fingerprint(cfg)
    assert_state_equal(tckpt.load_checkpoint(path, extended, device="cpu"), d)
    retuned = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                       diff_uv=12345.0))
    with pytest.raises(ValueError, match="numerics.diff_uv"):
        tckpt.load_checkpoint(path, retuned, device="cpu")
    st, mm = tckpt.load_checkpoint_ex(path, retuned, force=True,
                                      device="cpu")
    assert_state_equal(st, d)
    _, mm_ref = jckpt.load_checkpoint_ex(path, jax_cfg(retuned), force=True)
    assert mm == mm_ref == {"numerics.diff_uv": {
        "saved": cfg.numerics.diff_uv, "current": 12345.0}}


def test_checkpoint_detects_default_retune(tmp_path):
    """A saved record at an old default value (the pre-retune ocean
    albedo) is refused by both packages with the same record; an unknown
    saved field and a policy flip (adaptive dt) are not."""
    cfg = io_cfg()
    path = str(tmp_path / "restart.npz")
    st0 = convert.state_from_numpy(state_np(np.float64), device="cpu",
                                   dtype=torch.float64)
    tckpt.save_checkpoint(path, st0, cfg)
    items = npz_items(path)
    rec = json.loads(bytes(items["_config_json"]).decode())
    rec["physics"]["albedo_ocean"] = 0.08
    rec["physics"]["future_switch"] = True
    items["_config_json"] = np.frombuffer(
        json.dumps(rec, sort_keys=True).encode(), dtype=np.uint8)
    np.savez(path, **items)
    with pytest.raises(ValueError, match="physics.albedo_ocean"):
        tckpt.load_checkpoint(path, cfg, device="cpu")
    _, mm = tckpt.load_checkpoint_ex(path, cfg, force=True, device="cpu")
    _, mm_ref = jckpt.load_checkpoint_ex(path, jax_cfg(cfg), force=True)
    assert mm == mm_ref == {"physics.albedo_ocean": {
        "saved": 0.08, "current": cfg.physics.albedo_ocean}}
    adaptive = cfg.replace(numerics=dataclasses.replace(cfg.numerics,
                                                        adaptive_dt=True))
    _, mm = tckpt.load_checkpoint_ex(path, adaptive, force=True, device="cpu")
    assert list(mm) == ["physics.albedo_ocean"]


@pytest.mark.parametrize("run_dir", TRACKED)
def test_tracked_reference_checkpoints(run_dir):
    """The reference's own runs load bit for bit in the port; where the
    port's ``baseline_config(3)`` with continents differs from the saved
    record, both packages report the same mismatch record."""
    path = os.path.join(ROOT, run_dir, "restart.npz")
    cfg = tcfg.resolve_rad_interval(
        tcfg.baseline_config(3).replace(topo="continents"))
    st, mm = tckpt.load_checkpoint_ex(path, cfg, force=True, device="cpu")
    assert_state_equal(st, npz_items(path))
    _, mm_ref = jckpt.load_checkpoint_ex(path, jax_cfg(cfg), force=True)
    assert mm == mm_ref
    if run_dir == "out_annual_continents":
        assert mm["grid.nx"] == {"saved": 180, "current": 360}


def test_legacy_checkpoint_refused():
    path = os.path.join(ROOT, "out_adapt", "restart.npz")
    cfg = tcfg.baseline_config(3)
    for force in (False, True):
        with pytest.raises(ValueError, match="legacy checkpoint"):
            tckpt.load_checkpoint(path, cfg, force=force, device="cpu")


def test_checkpoint_shard_sets(tmp_path):
    """A ``.p*`` set (two files, rows 0-4 and 5-9) reassembles bit for bit
    in both packages; a set that leaves a row out is refused by both."""
    cfg = io_cfg()
    path = str(tmp_path / "restart.npz")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tckpt.load_checkpoint(path, cfg, device="cpu")
    d = state_np(np.float64)
    rec = np.frombuffer(json.dumps(tckpt.config_identity(cfg),
                                   sort_keys=True).encode(), np.uint8)

    def write_set(second_rows):
        for p, rows in enumerate((slice(0, 5), second_rows)):
            items = {"_config_json": rec}
            for k, v in d.items():
                if v.ndim == 0:
                    items[k] = v
                    continue
                starts = [0] * (v.ndim - 2) + [rows.start, 0]
                items[f"{k}@" + ",".join(map(str, starts))] = v[..., rows, :]
            np.savez(f"{path}.p{p}.npz", **items)
            os.replace(f"{path}.p{p}.npz", f"{path}.p{p}")

    write_set(slice(5, 10))
    assert_state_equal(tckpt.load_checkpoint(path, cfg, device="cpu"), d)
    ref = jckpt.load_checkpoint(path, jax_cfg(cfg))
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      d[name], err_msg=name)
    write_set(slice(6, 10))
    with pytest.raises(ValueError, match="do not cover"):
        tckpt.load_checkpoint(path, cfg, device="cpu")
    with pytest.raises(ValueError, match="do not cover"):
        jckpt.load_checkpoint(path, jax_cfg(cfg))


# ---------------------------------------------------------------------------
# NetCDF
# ---------------------------------------------------------------------------

def _nc_vars(path) -> dict:
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: (np.array(v[:]), dict(v._attributes))
                for k, v in f.variables.items()}


def _assert_nc_close(got_path, want_path):
    got, want = _nc_vars(got_path), _nc_vars(want_path)
    assert list(got) == list(want)
    for k, (w, attrs) in want.items():
        g, gattrs = got[k]
        assert g.dtype == w.dtype and w.dtype.itemsize == 4, k
        assert g.shape == w.shape, k
        assert gattrs == attrs, k
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=2.4e-7, atol=1e-9 * scale,
                                   err_msg=k)


def test_netcdf_matches_reference(tmp_path):
    cfg = io_cfg(physics=tcfg.PhysicsConfig(radiation=True, surface=True,
                                            turbulence=True,
                                            microphysics=True))
    d = state_np(np.float64)
    st, fo, g = jax_inputs(cfg)
    ts, tf, tg = port_inputs(d, fo, g)
    jg = jgrid.make_grid(jax_cfg(cfg).grid, jax_cfg(cfg).numerics,
                         dtype=jnp.float64)
    jf = JForcing(**{k: jnp.asarray(v) for k, v in fo.items()})
    a, b = tmp_path / "port", tmp_path / "ref"
    got = tnc.NCWriter(str(a)).write(ts, tg, tf)
    want = jnc.NCWriter(str(b)).write(jax_state(d), jg, jf)
    assert os.path.basename(got) == os.path.basename(want) == "out_0000.nc"
    _assert_nc_close(got, want)
    _assert_nc_close(str(a / "constants.nc"), str(b / "constants.nc"))
    tmp = tnc.NCWriter(str(a))       # a resume continues the sequence
    assert tmp.count == jnc.NCWriter(str(a)).count == 1
    assert os.path.basename(tmp.write(ts, tg, tf)) == "out_0001.nc"
    assert jnc.NCWriter(str(a)).count == tnc.NCWriter(str(a)).count == 2


# ---------------------------------------------------------------------------
# Metrics JSONL
# ---------------------------------------------------------------------------

def test_metrics_jsonl_matches_reference(tmp_path):
    cfg = io_cfg(physics=tcfg.PhysicsConfig(radiation=True, surface=True))
    d = state_np(np.float64)
    st, fo, g = jax_inputs(cfg)
    ts, tf, tg = port_inputs(d, fo, g)
    jg = jgrid.make_grid(jax_cfg(cfg).grid, jax_cfg(cfg).numerics,
                         dtype=jnp.float64)
    jf = JForcing(**{k: jnp.asarray(v) for k, v in fo.items()})
    recs = []
    for mod, diag, name in (
            (tmetrics, tmetrics.diagnostics(ts, tg, tf, cfg), "p.jsonl"),
            (jmetrics, jmetrics.diagnostics(jax_state(d), jg, jf,
                                            jax_cfg(cfg)), "r.jsonl")):
        path = str(tmp_path / name)
        mod.MetricsLogger(jsonl_path=path, grid_points=640,
                          quiet=True).log_chunk(diag, extra={"dt": 1309.7})
        recs.append([json.loads(x) for x in open(path)])
    (got,), (want,) = recs
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("wall_s", "grid_points_per_s"):
            continue
        assert type(got[k]) is type(v), k
        assert got[k] == pytest.approx(v, rel=1e-11, abs=1e-12), k


def test_metrics_begin_session(tmp_path):
    """As the reference's ``test_metrics_logger_resume_aware``; a second
    fresh run rotates to the next free suffix and keeps the first."""
    path = str(tmp_path / "metrics.jsonl")

    def write(steps):
        with open(path, "w") as f:
            for s in steps:
                f.write(json.dumps({"step": s}) + "\n")

    def steps(p):
        return [json.loads(x)["step"] for x in open(p)]

    write((100, 200, 300))
    tmetrics.MetricsLogger(jsonl_path=path, quiet=True).begin_session(200)
    assert steps(path) == [100, 200]
    tmetrics.MetricsLogger(jsonl_path=path, quiet=True).begin_session(0)
    assert not os.path.exists(path)
    assert steps(path + ".1") == [100, 200]
    write((5,))
    tmetrics.MetricsLogger(jsonl_path=path, quiet=True).begin_session(0)
    assert steps(path + ".1") == [100, 200] and steps(path + ".2") == [5]
    open(path, "w").close()
    tmetrics.MetricsLogger(jsonl_path=path, quiet=True).begin_session(0)
    assert open(path).read() == ""
    assert not os.path.exists(path + ".3")


# ---------------------------------------------------------------------------
# Topography and namelists
# ---------------------------------------------------------------------------

def elevation_file(path, island=(30.0, 120.0), shape=(180, 360)):
    """A synthetic ETOPO-like NetCDF file: one gaussian island in an
    ocean, on a fine lat-lon grid."""
    from scipy.io import netcdf_file

    slat = np.linspace(-85, 85, shape[0])
    slon = np.linspace(0, 359, shape[1])
    la, lo = np.meshgrid(slat, slon, indexing="ij")
    z = 7000.0 * np.exp(-(((la - island[0]) / 10) ** 2
                          + ((lo - island[1]) / 10) ** 2)) - 4000.0
    with netcdf_file(path, "w") as f:
        f.createDimension("lat", len(slat))
        f.createDimension("lon", len(slon))
        v = f.createVariable("lat", "d", ("lat",))
        v[:] = slat
        v = f.createVariable("lon", "d", ("lon",))
        v[:] = slon
        v = f.createVariable("z", "d", ("lat", "lon"))
        v[:] = z
    return path


def test_topography_loaders_equal(tmp_path):
    path = elevation_file(str(tmp_path / "etopo.nc"))
    cfg = io_cfg(nx=36, ny=18, nz=4)
    grid_np = make_grid(cfg.grid, cfg.numerics, np_mode=True)
    jgrid_np = jgrid.make_grid(jax_cfg(cfg).grid, jax_cfg(cfg).numerics,
                               np_mode=True)
    hsurf, land = ttopo.load_topography(path, grid_np)
    want_h, want_l = jtopo.load_topography(path, jgrid_np)
    np.testing.assert_array_equal(hsurf, want_h)
    np.testing.assert_array_equal(land, want_l)
    assert land.max() == 1.0 and land.mean() < 0.2        # one island
    assert hsurf[land < 0.5].max() == 0.0


def test_initialize_topo_file_matches_reference(tmp_path):
    path = elevation_file(str(tmp_path / "etopo.nc"))
    cfg = io_cfg(nx=36, ny=18, nz=4, topo_file=path)
    sj, fj, _ = jinit.initialize(jax_cfg(cfg))
    st, fo, _ = tinit.initialize(cfg, device="cpu")
    for a, b in ((sj, st), (fj, fo)):
        for f in dataclasses.fields(b):
            y = getattr(b, f.name)
            if isinstance(y, torch.Tensor):
                np.testing.assert_allclose(y.numpy(),
                                           np.asarray(getattr(a, f.name)),
                                           rtol=1e-12, atol=1e-12,
                                           err_msg=f.name)
    assert float(fo.land_mask.max()) == 1.0


@pytest.mark.parametrize("path", TOMLS, ids=os.path.basename)
def test_namelists_equal(path):
    assert dataclasses.asdict(tnamelist.load_config(path)) \
        == dataclasses.asdict(jnamelist.load_config(path))


def test_namelist_roundtrip_and_unknown_keys(tmp_path):
    p = tmp_path / "nl.toml"
    p.write_text('sim_days = 0.5\ndtype = "float64"\n\n[grid]\nnx = 20\n'
                 'ny = 12\nnz = 4\n\n[physics]\nmicrophysics = true\n\n'
                 '[numerics]\ntime_stepping = "rk4"\ndiff_pott = 100.0\n')
    cfg = tnamelist.load_config(str(p))
    assert dataclasses.asdict(cfg) \
        == dataclasses.asdict(jnamelist.load_config(str(p)))
    assert cfg.grid.nx == 20 and cfg.numerics.time_stepping == "rk4"
    assert cfg.physics.microphysics and cfg.sim_days == 0.5
    for text, match in (("[grid]\nnnx = 3\n", r"unknown keys in \[grid\]"),
                        ("sim_dayz = 1.0\n", "unknown top-level keys")):
        (tmp_path / "bad.toml").write_text(text)
        with pytest.raises(ValueError, match=match):
            tnamelist.load_config(str(tmp_path / "bad.toml"))


def test_rad_every_hours_resolves_against_dt(tmp_path):
    p = tmp_path / "nl.toml"
    p.write_text("[grid]\nnx = 64\nny = 32\nnz = 4\n\n[physics]\n"
                 "radiation = true\nrad_every_hours = 1.0\n")
    cfg = tnamelist.load_config(str(p))
    dt = float(make_grid(cfg.grid, cfg.numerics, np_mode=True).dt)
    assert cfg.physics.rad_every_steps == max(1, round(3600.0 / dt)) != 6
    assert cfg.physics.rad_every_steps \
        == jnamelist.load_config(str(p)).physics.rad_every_steps


# ---------------------------------------------------------------------------
# Plots
# ---------------------------------------------------------------------------

def test_quicklook_plots(tmp_path):
    pytest.importorskip("matplotlib")
    from climate_model_tpu_torch.io import plot

    cfg = io_cfg()
    st, fo, g = tinit.initialize(cfg, device="cpu")
    nc = tnc.NCWriter(str(tmp_path)).write(st, g, fo)
    npz = str(tmp_path / "restart.npz")
    tckpt.save_checkpoint(npz, st, cfg)
    jsonl = str(tmp_path / "metrics.jsonl")
    logger = tmetrics.MetricsLogger(jsonl_path=jsonl, quiet=True)
    for hours in (1, 2):
        logger.log_chunk(tmetrics.diagnostics(
            st.replace(t=st.t + 3600.0 * hours), g, fo, cfg))
    pngs = [plot.quicklook_nc(nc, str(tmp_path / "a.png")),
            plot.quicklook_npz(npz, str(tmp_path / "b.png"),
                               grid_cfg=cfg.grid),
            plot.zonal_mean_npz(npz, str(tmp_path / "c.png")),
            plot.timeseries_jsonl(jsonl, str(tmp_path / "d.png"))]
    for png in pngs:
        assert os.path.getsize(png) > 10_000, png


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the round trip loads to the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    cfg = io_cfg(dtype="float32")
    st, _, _ = tinit.initialize(cfg, device=cuda_device)
    r = np.random.default_rng(3)
    st = st.replace(step=7, t=st.t + 9167.9, **{
        f: getattr(st, f) + torch.as_tensor(
            r.normal(0, 1e-3, getattr(st, f).shape), dtype=st.dtype,
            device=cuda_device) for f in ("u", "v", "pott", "dpottdt_rad")})
    path = str(tmp_path / "restart.npz")
    tckpt.save_checkpoint(path, st, cfg)
    back = tckpt.load_checkpoint(path, cfg, device=cuda_device)
    assert back.step == st.step
    for name in STATE_FIELDS:
        if name != "step":
            x, y = getattr(back, name), getattr(st, name)
            assert x.device == y.device and x.dtype == y.dtype, name
            assert torch.equal(x, y), name
