"""The port's ``run`` with files, end to end (CPU, fp64).

* ``run --out-dir`` followed by ``--restart-from`` equals one continuous
  run bit for bit (checkpoint, last NetCDF file), runs only the remainder,
  and leaves one metrics timeline; ``--auto-resume`` picks up the out-dir's
  own checkpoint; ``--force-resume`` records the branch.
* The port's CLI against the reference's CLI from the same argv: the same
  files, the final ``restart.npz`` and ``metrics.jsonl`` within the port's
  fp64 tolerances (rtol 1e-9, atol 1e-10, as ``test_torch_model.py``). One
  reference run serves the module.
* ``--topo-file``, ``--config`` and the ``plot`` subcommand.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from climate_model_tpu import cli as jcli
from climate_model_tpu.io import topo as jtopo
from climate_model_tpu_torch import cli
from climate_model_tpu_torch.core.grid import make_grid
from climate_model_tpu_torch.core.namelist import load_config

from .test_torch_io import elevation_file, npz_items

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["run", "--nx", "16", "--ny", "10", "--nz", "4", "--physics", "all",
         "--dtype", "float64", "--out-every-hours", "0.3"]
# the packed scan (the kernels' plain versions on the CPU), adaptive dt
PACKED = SMALL + ["--backend", "pallas", "--adaptive-dt"]


def port(argv, **kw):
    """``cli.run`` of ``argv`` on the CPU with ``run``'s keywords."""
    return cli.run(cli.build_config(cli.make_parser().parse_args(argv)),
                   device="cpu", **kw)


def metric_steps(path):
    return [json.loads(x)["step"] for x in open(path)]


def nc_vars(path) -> dict:
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:]) for k, v in f.variables.items()}


def test_split_run_equals_continuous(tmp_path):
    """7 steps in one run against 3 + 4 across a checkpoint (radiation every
    6 steps, so the resumed run starts between refreshes and needs the
    saved caches)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = port(PACKED + ["--days", "0.1"], out_dir=a)
    first = port(PACKED + ["--days", "0.05"], out_dir=b)
    second = port(PACKED + ["--days", "0.1"], out_dir=b,
                  restart_from=os.path.join(b, "restart.npz"))
    assert (full.start_step, full.steps) == (0, 7)
    assert (first.start_step, first.steps) == (0, 3)
    assert (second.start_step, second.steps) == (3, 4)
    want, got = npz_items(os.path.join(a, "restart.npz")), \
        npz_items(os.path.join(b, "restart.npz"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert metric_steps(os.path.join(b, "metrics.jsonl")) \
        == metric_steps(os.path.join(a, "metrics.jsonl")) == list(range(1, 8))
    for k, v in nc_vars(os.path.join(a, "out_0006.nc")).items():
        np.testing.assert_array_equal(
            nc_vars(os.path.join(b, "out_0006.nc"))[k], v, err_msg=k)
    assert sorted(os.listdir(b)) == sorted(os.listdir(a))


def test_auto_resume(tmp_path):
    out = str(tmp_path / "out")
    fresh = port(PACKED + ["--days", "0.05"], out_dir=out, auto_resume=True,
                 no_nc=True)
    assert fresh.start_step == 0
    again = port(PACKED + ["--days", "0.1"], out_dir=out, auto_resume=True,
                 no_nc=True)
    assert (again.start_step, again.steps) == (3, 4)
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "restart.npz"]
    full = port(PACKED + ["--days", "0.1"])
    for f in ("u", "pott", "qv", "dpottdt_rad", "t"):
        np.testing.assert_array_equal(getattr(again.state, f).numpy(),
                                      getattr(full.state, f).numpy(),
                                      err_msg=f)
    # a finished run resumed again runs nothing and keeps its timeline
    done = port(PACKED + ["--days", "0.1"], out_dir=out, auto_resume=True,
                no_nc=True)
    assert (done.start_step, done.steps) == (7, 0)
    assert metric_steps(os.path.join(out, "metrics.jsonl")) \
        == list(range(1, 8))


def test_force_resume_records_branch(tmp_path):
    """As the reference's ``test_cli_force_resume_persists_branch_provenance``,
    through the port's ``main``."""
    out = str(tmp_path / "out")
    base = ["run", "--nx", "16", "--ny", "10", "--nz", "4", "--dtype",
            "float64", "--device", "cpu", "--no-nc"]
    assert cli.main(base + ["--days", "0.05", "--out-dir", out]) == 0
    branch = str(tmp_path / "branch")
    args = base + ["--days", "0.1", "--diff", "77.0", "--restart-from",
                   os.path.join(out, "restart.npz"), "--out-dir", branch]
    with pytest.raises(ValueError, match="numerics.diff_uv"):
        cli.main(args)
    assert cli.main(args + ["--force-resume"]) == 0
    recs = [json.loads(x)
            for x in open(os.path.join(branch, "forced_branch.jsonl"))]
    assert len(recs) == 1 and recs[0]["step"] == 3
    assert recs[0]["mismatch"]["numerics.diff_uv"]["current"] == 77.0
    assert recs[0]["restart_from"].endswith("restart.npz")


@pytest.fixture(scope="module")
def reference_cli(tmp_path_factory):
    """One run of the reference's CLI (its default ``jnp`` backend) and of
    the port's from the same argv, each into its own out-dir."""
    root = tmp_path_factory.mktemp("cli")
    argv = SMALL + ["--days", "0.05"]
    ref, mine = str(root / "ref"), str(root / "port")
    assert jcli.main(argv + ["--out-dir", ref]) == 0
    assert cli.main(argv + ["--out-dir", mine, "--device", "cpu"]) == 0
    return ref, mine


def test_cli_files_match_reference(reference_cli):
    ref, mine = reference_cli
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref)) == [
        "constants.nc", "metrics.jsonl", "out_0000.nc", "out_0001.nc",
        "out_0002.nc", "restart.npz"]
    want = npz_items(os.path.join(ref, "restart.npz"))
    got = npz_items(os.path.join(mine, "restart.npz"))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if k in ("step", "_config_json"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        elif k != "_fingerprint":
            np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-10,
                                       err_msg=k)
    np.testing.assert_array_equal(got["_fingerprint"], want["_fingerprint"])


def test_cli_metrics_match_reference(reference_cli):
    ref, mine = reference_cli
    want = [json.loads(x) for x in open(os.path.join(ref, "metrics.jsonl"))]
    got = [json.loads(x) for x in open(os.path.join(mine, "metrics.jsonl"))]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k not in ("wall_s", "grid_points_per_s"):
                assert g[k] == pytest.approx(v, rel=1e-9, abs=1e-10), k


def test_cli_topo_file(tmp_path):
    """``--topo-file`` end to end: the run's constants file carries the
    reference loader's HSURF and land mask."""
    path = elevation_file(str(tmp_path / "etopo.nc"), island=(35.0, 100.0),
                          shape=(60, 120))
    out = str(tmp_path / "out")
    res = port(["run", "--nx", "24", "--ny", "12", "--nz", "4", "--physics",
                "mic", "--days", "0.02", "--dtype", "float64", "--topo-file",
                path], out_dir=out)
    assert res.steps >= 1 and not res.aborted
    cfg = cli.build_config(cli.make_parser().parse_args(
        ["run", "--nx", "24", "--ny", "12", "--nz", "4"]))
    hsurf, land = jtopo.load_topography(
        path, make_grid(cfg.grid, cfg.numerics, np_mode=True))
    const = nc_vars(os.path.join(out, "constants.nc"))
    np.testing.assert_array_equal(const["HSURF"], hsurf.astype(np.float32))
    np.testing.assert_array_equal(const["LAND_MASK"], land.astype(np.float32))
    assert land.max() == 1.0


def test_cli_config_toml(tmp_path):
    toml = os.path.join(ROOT, "configs", "baseline_1.toml")
    args = cli.make_parser().parse_args(["run", "--config", toml, "--days",
                                         "0.01"])
    cfg = cli.build_config(args)
    assert cfg == load_config(toml).replace(sim_days=0.01)
    out = str(tmp_path / "out")
    assert cli.main(["run", "--config", toml, "--days", "0.01", "--device",
                     "cpu", "--out-dir", out, "--no-nc"]) == 0
    with np.load(os.path.join(out, "restart.npz")) as z:
        assert z["u"].shape == (cfg.grid.nz, cfg.grid.ny, cfg.grid.nx)
        rec = json.loads(bytes(z["_config_json"]).decode())
    assert rec["grid"] == dataclasses.asdict(cfg.grid)


def test_cli_plot(tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "out")
    port(SMALL + ["--days", "0.05"], out_dir=out)
    for argv in (["plot", os.path.join(out, "out_0002.nc")],
                 ["plot", os.path.join(out, "restart.npz"), "--zonal",
                  "--out", os.path.join(out, "zonal.png")],
                 ["plot", os.path.join(out, "restart.npz"), "--baseline",
                  "1"],
                 ["plot", os.path.join(out, "metrics.jsonl")]):
        assert cli.main(argv) == 0
    for png in ("out_0002.png", "zonal.png", "restart.png", "metrics.png"):
        assert os.path.getsize(os.path.join(out, png)) > 10_000, png
