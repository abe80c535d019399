"""The shape of a run's last line, untraced and traced."""

import io
import json

import pytest

from harness.cell import print_result


@pytest.mark.parametrize("cell", ["tiny-lr.ssgd", "tiny-lr.ma4"])
def test_untraced_line(run_tiny, cell):
    res = run_tiny(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"train_rows_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["tiny-lr.ssgd", "tiny-lr.ma4"])
def test_traced_line(run_tiny, cell):
    res = run_tiny(cell, trace=True)
    # no card: no device operation to read, so no device metric
    assert set(res["metrics"]) == {"prepare_s"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["device"]["window_s"] > 0
    bd = res["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert len(bd["device_ops"]) <= 10 and 1 <= len(bd["idle_gaps"]) <= 10
    assert list(res)[-1] == "checks"


def test_printed_line_is_last_and_checks_on_stderr(run_tiny):
    res = run_tiny("tiny-lr.ssgd")
    out, err = io.StringIO(), io.StringIO()
    print("earlier output", file=out)
    print_result(res, out, err)
    last = out.getvalue().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(res))
    tail = err.getvalue().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)
