"""``gen.dynamic`` through the harness at a tiny size: its runs are correct
against the dynamic reference and its control is not; the posing readers
read the program's ``generate/pose`` ranges and return None where a trace
has none, as the parent program's has not."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import tiny_gen

import readings_dynamic
from harness.core import Run, load_cell, metric_reader, result_line
from harness.trace import Event

POSE_METRICS = ("pose_device_ms_per_frame.dyn", "pose_launches_per_frame.dyn", "pose_roofline.dyn")


@pytest.fixture
def tiny_dynamic():
    torch.set_num_threads(1)
    return tiny_gen(load_cell("gen.dynamic"))


def test_rehearsal_is_correct(tiny_dynamic, execute):
    run, metrics, dev, breakdown = execute(tiny_dynamic)
    out = json.loads(result_line(run, metrics, dev, breakdown))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] == 2
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert [r["poses"] for r in run.facts["records"]] == [12, 12]
    assert {m["name"] for m in tiny_dynamic.per_layer} == set(POSE_METRICS)


def test_traced_rehearsal_reads_no_device_posing(tiny_dynamic, execute):
    """On the CPU the ranges are there but no device event: every posing
    reader stays silent and the run is correct."""
    run, metrics, dev, _ = execute(tiny_dynamic, trace=True)
    assert metrics == {} and dev["busy_s"] == 0
    assert any(e.name == "generate/pose" for e in run.facts["trace_events"])
    assert all(c.ok for c in run.checks)


def test_control_is_not_correct(tiny_dynamic, cache, tmp_path):
    numbers = readings_dynamic.control_numbers(tiny_dynamic, 2**31 + 5, torch.device("cpu"), tmp_path,
                                               cache=cache)
    limits = tiny_dynamic.config["limits"]
    assert set(numbers) == set(limits)
    assert [n for n in numbers if not numbers[n] <= limits[n]], numbers


def _events(with_pose: bool):
    """Two scenes' ranges; inside each, posing's range (if ``with_pose``)
    with two launches of 100 us kernels and a copy, then a render launch."""
    host = lambda name, a, b, corr=0: Event(name, False, a, b, corr, "/" in name)
    dev = lambda name, a, b, corr=0: Event(name, True, a, b, corr, "/" in name)
    out = []
    for k, t0 in enumerate((0, 10_000)):
        c = 10 * k
        out += [host(f"h100_bench/scene00{k}", t0, t0 + 5_000)]
        if with_pose:
            out += [host("generate/pose", t0 + 10, t0 + 1_000),
                    dev("generate/pose", t0 + 100, t0 + 1_300)]
        out += [host("cudaLaunchKernel", t0 + 20, t0 + 22, corr=c + 1),
                host("cudaLaunchKernel", t0 + 30, t0 + 32, corr=c + 2),
                host("cudaMemcpyAsync", t0 + 40, t0 + 42, corr=c + 3),
                host("cudaLaunchKernel", t0 + 2_000, t0 + 2_002, corr=c + 4),
                dev("index_kernel", t0 + 100, t0 + 200, corr=c + 1),
                dev("bmm_kernel", t0 + 200, t0 + 300, corr=c + 2),
                dev("Memcpy DtoH", t0 + 300, t0 + 310, corr=c + 3),
                dev("composite_tiles_kernel", t0 + 2_100, t0 + 3_100, corr=c + 4)]
    return out


def _run(events):
    run = Run(cell=load_cell("gen.dynamic"), seed=1, seconds=0.0, trace=True,
              device=torch.device("cpu"), workdir=None)
    run.facts.update(trace_events=events, trace={"busy_s": 1.0, "window_s": 2.0, "launches": 8}, frames=4,
                     checked={"scene": {"name": "scene001", "n_objects": 1}},
                     **{"bounds:pose_bound": {"least_ms": 0.0021, "bound_by": "bytes", "moving_splats": 7,
                                              "frames": 2, "bytes": 7000, "ops": 10}})
    return run


def test_posing_readers_read_the_ranges():
    run = _run(_events(with_pose=True))
    read = {m: metric_reader(m).read(run, None) for m in POSE_METRICS}
    assert read["pose_device_ms_per_frame.dyn"] == pytest.approx(2 * 0.21 / 4)  # two scenes' 210 us
    assert read["pose_launches_per_frame.dyn"] == pytest.approx(4 / 4)
    assert read["pose_roofline.dyn"] == pytest.approx(100 * 0.0021 / 0.21)  # scene001's alone


def test_posing_readers_return_none_without_the_range():
    run = _run(_events(with_pose=False))
    assert all(metric_reader(m).read(run, None) is None for m in POSE_METRICS)
    run.facts.pop("trace_events")
    assert all(metric_reader(m).read(run, None) is None for m in POSE_METRICS)


def test_pose_work_counts_the_moving_splats():
    """Per frame and moving splat: 420 bytes (xyz, quaternion and 45 band
    floats read and written, the body id read) and 505 operations."""
    from harness.posing import pose_least, pose_work
    from reference.frozen.gs.cloud import GaussianCloud
    from reference.frozen.scene.composition import SceneTemplate

    def cloud(n):
        z = torch.zeros
        return GaussianCloud(xyz=torch.randn(n, 3), f_dc=z(n, 1, 3), f_rest=z(n, 15, 3), opacity=z(n, 1),
                             scale=z(n, 3), rot=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
                             object_id=z(n, dtype=torch.int32), alive=torch.ones(n, dtype=torch.bool))

    template = SceneTemplate.build(cloud(50), [cloud(7), cloud(5)])
    work = pose_work(template, 300)
    assert work == {"moving_splats": 12, "frames": 300, "bytes": 300 * 12 * 420, "ops": 300 * 12 * 505}
    least = pose_least(template, 300)
    assert least["bound_by"] == "bytes"
    assert least["least_ms"] == pytest.approx(300 * 12 * 420 / 3.35e12 * 1e3)
