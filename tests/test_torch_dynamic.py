"""Dynamic mode on the port's normal path: a small dynamic scene through
``run_generation`` against the benchmark's plain dynamic reference
(``h100_bench/reference/generation_dynamic.py``: every frame's annotations
at that frame's step, the sampled frames each posed by its own pose alone),
within ``pegaset_dynamic``'s limits; each fault of posing crosses one of
them; posing's ``generate/pose`` ranges and counters; the preview videos
encoded off the frame loop (both modes); and the rotation of a splat's
colour by its SH bands.

Torch only, on the CPU: 64x48, 2 cameras x 6 steps (a chunk of 8 and a
tail of 4), 2 objects of 400 splats on a 3,000-splat environment.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
for i, p in enumerate((str(BENCH), str(BENCH.parent))):
    if p not in sys.path:
        sys.path.insert(i, p)

SEED = 2**31 + 123
CPU = torch.device("cpu")


def tiny(name: str):
    """The cell ``name`` at a size a test holds (the benchmark tests'
    ``tiny_gen``, one scene of 2 objects a round)."""
    from harness.core import load_cell

    cell = load_cell(name)
    c = cell.config
    c["generation"].update(render_width=64, render_height=48, simulation_steps=40, save_video=False)
    c["objects"] = c["objects"][:4]
    c["assets"] = dict(c["assets"], env_splats=3000, obj_splats=400, colmap_images=8)
    cell.traffic["scene"].update(num_cameras=2, num_camera_interpolation_steps=6)
    cell.traffic["object_counts"] = [2]
    cell.traffic["warmup"] = dict(cell.traffic["warmup"], cameras=1, interpolation_steps=3)
    cell.traffic["check"] = {"frames": 4}
    return cell


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """cells(name): (cell, runner, set-up, work directory) of a tiny cell,
    set up once per module; a run's scenes go into the set-up's directory."""
    from harness.core import Run, entry_runner

    torch.set_num_threads(1)
    cache = tmp_path_factory.mktemp("dynamic_cache")
    made = {}

    def get(name: str):
        if name not in made:
            cell = tiny(name)
            runner = entry_runner(cell.config)
            work = tmp_path_factory.mktemp(name.replace(".", "_"))
            run = Run(cell=cell, seed=0, seconds=0.0, trace=False, device=CPU, workdir=work)
            run.cache = cache
            made[name] = (cell, runner, runner.setup(run), work)
        return made[name]

    return get


def numbers_of(cells, seed: int = SEED) -> dict:
    """The program's numbers of one round of the tiny dynamic cell."""
    import readings

    cell, runner, ctx, work = cells("gen.dynamic")
    for d in work.iterdir():
        if d.name.startswith(("scene", "reference")):
            shutil.rmtree(d)
    numbers, _ = readings.program_numbers(runner, cell, seed, CPU, work, ctx)
    return numbers


def test_dynamic_scene_matches_the_reference(cells):
    cell = cells("gen.dynamic")[0]
    assert cell.config["generation"]["mode"] == cell.traffic["scene"]["mode"] == "dynamic"
    numbers = numbers_of(cells)
    limits = cell.config["limits"]
    assert set(numbers) == set(limits)
    assert all(numbers[n] <= limits[n] for n in numbers), numbers


@pytest.mark.parametrize("fault", ["step_behind", "step_zero", "frozen_gt", "sh_unrotated"])
def test_a_fault_of_posing_crosses_a_limit(fault, cells):
    import readings_dynamic

    limits = cells("gen.dynamic")[0].config["limits"]
    with readings_dynamic.fault(fault):
        numbers = numbers_of(cells)
    assert [n for n in numbers if not numbers[n] <= limits[n]], numbers


@pytest.mark.parametrize("name,mode", [("gen.dynamic", "dynamic"), ("gen.static", "static")])
def test_pose_ranges_and_counters(name, mode, cells, monkeypatch):
    """``generate/pose`` opens once per scene (static) or once per scene
    and once per chunk (dynamic); the stats record counts the poses, the
    splats they wrote and the object splats among them."""
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.pegasus import PEGASUS

    cell, _, ctx, work = cells(name)
    config = dataclasses.replace(ctx["base"], dataset_name=f"ranges_{mode}", min_num_objects=2,
                                 max_num_objects=2, seed=5)
    ctx["pegasus"].rng = np.random.default_rng(5)
    events, generate = [], PEGASUS.generate_dataset

    def profiled(self, *a, **k):  # the scene's frames under the profiler, its drop not
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            generate(self, *a, **k)
        events.extend(e.name for e in prof.events())
    monkeypatch.setattr(PEGASUS, "generate_dataset", profiled)
    stats = ctx["run_generation"](config, ctx["envs"], ctx["objs"], pegasus=ctx["pegasus"], device=CPU)
    monkeypatch.undo()
    opened = events.count("generate/pose")
    n_frames = config.num_cameras * config.num_camera_interpolation_steps
    chunks = -(-n_frames // config.frame_chunk)
    assert (n_frames, chunks) == (12, 2)
    rec = stats.records[-1]
    poses = n_frames if mode == "dynamic" else 1
    assert opened == (1 + chunks if mode == "dynamic" else 1)
    a = cell.config["assets"]
    assert rec["splats"] == a["env_splats"] + 2 * a["obj_splats"]
    assert (rec["poses"], rec["posed_splats"], rec["moving_splats"]) == (
        poses, poses * rec["splats"], poses * 2 * a["obj_splats"])
    assert "poses" not in ctx["pegasus"].last_render_stats
    shutil.rmtree(work / config.dataset_name)


@pytest.mark.parametrize("name,mode", [("gen.dynamic", "dynamic"), ("gen.static", "static")])
def test_videos_are_encoded_off_the_frame_loop(name, mode, cells, monkeypatch):
    """With ``save_video``, each scene writes its five mp4s of ``n_frames``
    frames on the streams' worker: no ``cv2.VideoWriter.write`` runs on the
    thread that runs the frame loop, and the stats record counts the frames
    handed over and the seconds waited."""
    import threading

    import cv2

    cell, _, ctx, work = cells(name)
    config = dataclasses.replace(ctx["base"], dataset_name=f"video_{mode}", min_num_objects=2,
                                 max_num_objects=2, seed=5, save_video=True)
    ctx["pegasus"].rng = np.random.default_rng(5)
    writes, real = [], cv2.VideoWriter

    class Recorded:
        def __init__(self, *args):
            self.writer = real(*args)

        def write(self, frame):
            writes.append(threading.get_ident())
            self.writer.write(frame)

        def release(self):
            self.writer.release()

    monkeypatch.setattr(cv2, "VideoWriter", Recorded)
    stats = ctx["run_generation"](config, ctx["envs"], ctx["objs"], pegasus=ctx["pegasus"], device=CPU)
    monkeypatch.undo()
    n_frames = config.num_cameras * config.num_camera_interpolation_steps
    rec = stats.records[-1]
    assert rec["frames"] == rec["video_frames"] == n_frames
    assert rec["video_wait_s"] >= 0 and rec["video_drain_s"] >= 0
    assert len(writes) == 5 * n_frames and threading.get_ident() not in writes
    videos = work / config.dataset_name / "video" / "000001"
    for stream in ("rgb", "object_center", "seg", "rgb_seg", "depth"):
        cap, count = cv2.VideoCapture(str(videos / f"{stream}_video.mp4")), 0
        while cap.read()[0]:
            count += 1
        cap.release()
        assert count == n_frames, stream
    shutil.rmtree(work / config.dataset_name)


def _rotation(q) -> torch.Tensor:
    w, x, y, z = (q / torch.linalg.vector_norm(q)).tolist()
    return torch.tensor([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                        dtype=torch.float64)


@settings(max_examples=25, deadline=None)
@given(q=st.lists(st.floats(-1.0, 1.0), min_size=4, max_size=4).filter(
           lambda v: sum(x * x for x in v) > 0.01),
       seed=st.integers(0, 2**31 - 1))
def test_band_rotation_rotates_the_colour(q, seed):
    """A splat rotated by R shows in direction v the colour it showed in
    R^T v: eval_sh(D(R) c, v) == eval_sh(c, R^T v) for bands 1-3, whatever
    way D is computed."""
    from pegasus_tpu_torch.utils import sh

    R = _rotation(torch.tensor(q, dtype=torch.float64))
    g = torch.Generator().manual_seed(seed)
    coeffs = torch.randn(16, 3, generator=g, dtype=torch.float64)
    dirs = torch.nn.functional.normalize(torch.randn(32, 3, generator=g, dtype=torch.float64), dim=-1)
    rotated, start = [coeffs[:1]], 1
    for band in (1, 2, 3):
        d = 2 * band + 1
        rotated.append(sh.sh_band_rotation(R, band) @ coeffs[start:start + d])
        start += d
    got = sh.eval_sh(3, torch.cat(rotated)[None].expand(32, 16, 3), dirs)
    want = sh.eval_sh(3, coeffs[None].expand(32, 16, 3), dirs @ R)  # rows R^T v
    assert torch.allclose(got, want, atol=1e-5, rtol=0), (got - want).abs().max()
