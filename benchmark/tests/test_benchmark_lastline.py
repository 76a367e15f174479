"""A run's last line: exactly ``correct``, ``attempted``, ``failed``,
``metrics`` and ``device`` (and ``breakdown`` when traced), then the
numbers compared; a small cell on the CPU through the whole harness."""

import json

import pytest

from benchmark import harness, report

from ._small import run_small, small_cell


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    res = run_small("bl3_run", trace=trace)
    line = report.result_line(small_cell("bl3_run"), res, trace,
                              harness.manifest())
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        want.append("breakdown")
    assert list(line) == want + ["checks"]
    json.dumps(line)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"sypd", "gpts_per_s_chip",
                                        "setup_s"}
    assert {"start", "dt", "u", "pott"} <= set(line["checks"])


def test_window_counts_whole_chunks():
    res = run_small("bl3_run")
    info = res["info"]
    assert info["chunks"] == res["attempted"] >= 3
    assert 1 <= info["compare"] <= info["chunks"]
    assert info["sim_s"] > 0 and info["steps"] > 0
    assert res["readings"]["start"] == 0.0 and res["readings"]["dt"] == 0.0
