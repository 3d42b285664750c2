"""A configuration, a traffic mix, an entry runner and a metric reader
placed in a new directory are found by the names BENCHMARK.json gives them:
adding a cell adds files and entries and edits none."""

from __future__ import annotations

import json

from harness.core import BENCH, entry_runner, load_cell, metric_reader


def test_new_cell_is_found_by_name(tmp_path):
    bench = tmp_path / BENCH.name
    for sub in ("configs", "traffic", "metrics", "entries"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "model_z.json").write_text(json.dumps({"entry": "probe", "size": 3}))
    (bench / "traffic" / "bursty.json").write_text(json.dumps({"rate": 9}))
    (bench / "entries" / "probe.py").write_text("def setup(run):\n    return {'probe': True}\n")
    (bench / "metrics" / "probe_ms.z.py").write_text("def read(run, ctx):\n    return 4.5\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "model_z", "file": f"{BENCH.name}/configs/model_z.json"}],
        "workloads": [{"name": "z.bursty", "config": "model_z", "traffic": "bursty", "chips": 1}],
        "end_to_end": [{"name": "rate", "unit": "1/s"},
                       {"name": "other", "unit": "1/s", "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "probe_ms.z", "unit": "ms", "workloads": ["z.bursty"]}],
    }))
    cell = load_cell("z.bursty", root=tmp_path)
    assert cell.config == {"entry": "probe", "size": 3} and cell.traffic == {"rate": 9}
    assert [m["name"] for m in cell.end_to_end] == ["rate"]
    assert [m["name"] for m in cell.per_layer] == ["probe_ms.z"]
    assert entry_runner(cell.config, bench=bench).setup(None) == {"probe": True}
    assert metric_reader("probe_ms.z", bench=bench).read(None, None) == 4.5


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert callable(entry_runner(cell.config).setup)
        for m in cell.per_layer:
            assert callable(metric_reader(m["name"]).read)
