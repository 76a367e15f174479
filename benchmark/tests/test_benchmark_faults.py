"""The harness with the timed path broken underneath: each fault that a cell
can have makes ``correct`` come out false. A small cell on the CPU, the
harness's look for a card skipped; the four-card cell on four gloo ranks."""

import json
import math
import multiprocessing as mp
import socket

import pytest

from ._small import run_small


def _over(res, name):
    v = res["readings"][name]
    limit = res_limits(res)[name]
    return not math.isfinite(v) or v > limit


def res_limits(res):
    return {n: lim for n, _, lim in res["checks"]}


def test_sound_run_is_correct():
    assert run_small("bl3_run")["correct"] is True


def test_chunk_returns_its_state_unchanged(monkeypatch):
    # the fields come back as they went in; time and the step counter move
    # on (with them unmoved too, cli.run's loop would never reach its
    # horizon)
    from climate_model_tpu_torch import model

    def unchanged(cfg, n, graphs=None):
        def go(state, grid, forcing=None):
            return state.replace(t=state.t + n * grid.dt,
                                 step=state.step + n)
        return go

    monkeypatch.setattr(model, "make_chunk_runner", unchanged)
    res = run_small("bl3_run")
    assert res["correct"] is False
    assert _over(res, "u") and _over(res, "pott")


def test_answer_altered_where_produced(monkeypatch):
    from climate_model_tpu_torch import model
    make = model.make_chunk_runner

    def altered(cfg, n, graphs=None):
        run = make(cfg, n, graphs)

        def go(state, grid, forcing=None):
            out = run(state, grid, forcing)
            pott = out.pott.clone()
            pott[3, 5, 7] += 1.0
            return out.replace(pott=pott)
        return go

    monkeypatch.setattr(model, "make_chunk_runner", altered)
    res = run_small("bl3_run")
    assert res["correct"] is False and _over(res, "pott")


def test_host_loop_dt_altered(monkeypatch):
    from climate_model_tpu_torch.core import grid
    rule = grid.adaptive_cfl_dt
    monkeypatch.setattr(grid, "adaptive_cfl_dt",
                        lambda *a: 0.9 * rule(*a))
    res = run_small("bl3_run")
    assert res["correct"] is False and _over(res, "dt")


def test_snapshot_altered(monkeypatch):
    from climate_model_tpu_torch.io import netcdf
    write = netcdf.write_output_nc

    def altered(path, state, grid, forcing):
        return write(path, state.replace(pott=state.pott + 0.5), grid,
                     forcing)

    monkeypatch.setattr(netcdf, "write_output_nc", altered)
    res = run_small("bl3_output")
    assert res["correct"] is False and _over(res, "nc_snapshot")
    assert not _over(res, "checkpoint")


def test_checkpoint_altered(monkeypatch):
    from climate_model_tpu_torch.io import checkpoint
    to_np = checkpoint.state_to_numpy

    def altered(state):
        d = to_np(state)
        d["u"] = d["u"] + 0.25
        return d

    monkeypatch.setattr(checkpoint, "state_to_numpy", altered)
    res = run_small("bl3_output")
    assert res["correct"] is False and _over(res, "checkpoint")


def test_sound_output_run_is_correct():
    res = run_small("bl3_output")
    assert res["correct"] is True
    assert res["readings"]["nc_snapshot"] == 0.0
    assert res["readings"]["checkpoint"] == 0.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _four_ranks(tmp_path, fault: str) -> dict:
    from ._ranks import rank_main
    out = tmp_path / "rank0.json"
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, port, fault, str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    return json.loads(out.read_text())


@pytest.mark.parametrize("fault,correct", [("", True),
                                           ("no_exchange", False)])
def test_four_ranks(tmp_path, fault, correct):
    res = _four_ranks(tmp_path, fault)
    assert res["correct"] is correct
    if not correct:
        assert max(res["readings"][f] for f in ("u", "v", "pott")) > 0


