"""The benchmark's CPU tests: the harness at tiny sizes with the program's
plain versions, the plain reference and its control, the faults, the
roofline count and the file discovery.  Run from the repository's root:

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for i, p in enumerate((str(BENCH), str(BENCH.parent))):
    if p not in sys.path:
        sys.path.insert(i, p)


def tiny_gen(cell):
    """``gen.static`` at a size a test holds: 64x48, 2 x 6 frames, a short
    drop, four objects of 400 splats on 3,000."""
    c = cell.config
    c["generation"].update(render_width=64, render_height=48, simulation_steps=40, save_video=False)
    c["objects"] = c["objects"][:4]
    c["assets"] = dict(c["assets"], env_splats=3000, obj_splats=400, colmap_images=8)
    cell.traffic["scene"].update(num_cameras=2, num_camera_interpolation_steps=6)
    cell.traffic["object_counts"] = [1, 2]
    cell.traffic["warmup"] = dict(cell.traffic["warmup"], cameras=1, interpolation_steps=3)
    cell.traffic["check"] = {"frames": 4}
    return cell


def tiny_train(cell):
    """``train.asset512`` at a size a test holds: 32x32 views of a
    2,000-splat box, 500 seeds in a buffer of 3,000, densify/prune from
    step 6 every 4 steps with thresholds at which both clone, split and
    prune have work."""
    cell.config["train"].update(capacity=3000, densify_from_iter=6, densification_interval=4,
                                densify_grad_threshold=4e-4, min_opacity=0.0998)
    cell.config["scan"].update(size=32, views=6, cloud_splats=2000, seed_points=500)
    cell.traffic.update(segment_iterations=4, traced_iterations=3)
    return cell


TINY = {"gen.static": tiny_gen, "train.asset512": tiny_train}


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("h100_bench_cache")


@pytest.fixture
def tiny_cell():
    """tiny_cell(name): a fresh tiny copy of the cell."""
    import torch

    from harness.core import load_cell

    torch.set_num_threads(1)
    return lambda name: TINY[name](load_cell(name))


@pytest.fixture
def execute(cache):
    """execute(cell, seed, trace=False): a whole run on the CPU."""
    import time

    import torch

    import run as run_py

    def go(cell, seed: int = 2**31 + 77, trace: bool = False):
        return run_py.execute(cell, seed, 0.5, trace, torch.device("cpu"),
                              t0=time.perf_counter(), cache=cache)

    return go
