"""Each cell rehearsed at a tiny size on the CPU prints a last line of the
contract's shape, and is correct."""

from __future__ import annotations

import json

import pytest

from harness.core import result_line


@pytest.mark.parametrize("name", ["gen.static", "train.asset512"])
def test_rehearsal_prints_the_result_line(name, tiny_cell, execute):
    cell = tiny_cell(name)
    run, metrics, dev, breakdown = execute(cell)
    out = json.loads(result_line(run, metrics, dev, breakdown))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    on_cpu = [m for m in cell.end_to_end if m["source"] != "device_trace"]  # no device readings here
    assert set(out["metrics"]) == {m["name"] for m in on_cpu}
    for m in on_cpu:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
        assert out["metrics"][m["name"]]["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"] and all(set(c) == {"value", "limit"} for c in out["checks"].values())


@pytest.mark.parametrize("name", ["gen.static", "train.asset512"])
def test_traced_rehearsal_reports_only_per_layer_metrics(name, tiny_cell, execute):
    cell = tiny_cell(name)
    run, metrics, dev, breakdown = execute(cell, trace=True)
    assert set(metrics) <= {m["name"] for m in cell.per_layer}
    assert dev["window_s"] > 0 and dev["busy_s"] == 0  # no device on the CPU: nothing device-side
    # host spans and counters are read; device readers find nothing and stay silent
    if name == "gen.static":
        assert {"physics_s_per_scene.gen", "render_ms_per_frame.gen", "finalize_s_per_scene.gen",
                "fetch_stall_ms_per_frame.gen"} <= set(metrics)
    assert not any("roofline" in m or "idle" in m for m in metrics)
    if name == "train.asset512":
        assert metrics["wall_ms_per_iter.train"]["value"] > 0
    assert all(c.ok for c in run.checks)
