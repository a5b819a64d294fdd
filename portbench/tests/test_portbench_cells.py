"""Each cell's harness path end to end at a tiny size on the CPU: the
result line's keys, the metrics a cell reports, the check."""

import math

import pytest

from portbench import harness

import tiny

CELLS = [w["name"] for w in tiny.MANIFEST["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(cell, bench_tmp):
    r = tiny.result_line(harness.run_cell(tiny.context(cell, bench_tmp)))
    assert list(r)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in harness.metrics_for(tiny.MANIFEST, cell, "end_to_end")}
    assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = harness.load_json(harness.BENCH_DIR / "limits" / f"{cell}.json")
    assert set(r["compared"]) == set(limits)
    for c in r["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell, bench_tmp):
    r = tiny.result_line(harness.run_cell(tiny.context(cell, bench_tmp, seed=777, trace=True)))
    assert r["correct"] is True
    allowed = {m["name"] for m in harness.metrics_for(tiny.MANIFEST, cell, "per_layer")}
    assert set(r["metrics"]) <= allowed
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    # on the CPU no device operation and no kernel is seen: the readers
    # of device shares leave their metrics out rather than read 0
    for name, m in r["metrics"].items():
        assert "roofline" not in name and "mfu" not in name
        assert math.isfinite(m["value"])


def test_same_seed_same_check(bench_tmp):
    """One job a window (seconds 0): the same seed, the same readings."""
    a = harness.run_cell(tiny.context("align-sat-librispeech", bench_tmp, seed=5, seconds=0))
    b = harness.run_cell(tiny.context("align-sat-librispeech", bench_tmp, seed=5, seconds=0))
    assert a["compared"] == b["compared"] and a["attempted"] == b["attempted"]
