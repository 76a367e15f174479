"""The manifest and the files it names: every entry resolves to its file by
name, and the manifest keeps the contract's shapes."""

import json
import os
import re
import tomllib

import pytest

from benchmark import harness, report

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = harness.manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert M["command"][1] == "benchmark/run.py"
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = os.path.join(harness.ROOT, cfg["file"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.toml"
    with open(path, "rb") as f:
        body = tomllib.load(f)
    assert body["benchmark"]["source"] == cfg["source"]
    assert body["benchmark"]["reduced"] == cfg["reduced"] == []
    assert any(w["config"] == cfg["name"] for w in M["workloads"])


@pytest.mark.parametrize("wl", M["workloads"], ids=lambda w: w["name"])
def test_workload_file(wl):
    cell = harness.load_cell(wl["name"])
    with open(os.path.join(harness.BENCH, "workloads",
                           f"{wl['name']}.json")) as f:
        body = json.load(f)
    assert (cell.config, cell.chips, body["why"]) == \
        (wl["config"], wl["chips"], wl["why"])
    assert wl["chips"] in (1, 4) and len(wl["why"]) <= 200
    assert {"start", "dt", "steps"} <= set(cell.limits)
    for m in M["end_to_end"] + M["per_layer"]:
        if report.applies(m, wl["name"]):
            assert callable(report.reader(m["name"]))


@pytest.mark.parametrize("m", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                       f"{m['name']}.py"))
    names = {w["name"] for w in M["workloads"]}
    assert set(m.get("workloads", names)) <= names
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        assert "\n" not in m["layer"]


def test_names_unique_and_cells_report_enough():
    names = [x["name"] for x in M["configs"] + M["workloads"]
             + M["end_to_end"] + M["per_layer"]]
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"]
               if report.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in M["per_layer"] if report.applies(m, w["name"])]
        assert per and all(m["moves"] in e2e for m in per)
