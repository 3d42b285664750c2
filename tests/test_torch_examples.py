"""The port's worked examples (``examples/torch_*.py``) run end to end on
the CPU at a tiny size: each is imported from its file and its ``main``
called with ``device="cpu"``."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_generate_dataset_example(tmp_path):
    stats = load("torch_generate_dataset").main(
        tmp_path, num_scenes=1, width=48, height=40, num_cameras=1, interpolation_steps=2,
        simulation_steps=20, device="cpu")
    assert len(stats.records) == 1
    scene = tmp_path / "pegasus_torch_example" / "train" / "000001"
    gt = json.loads((scene / "scene_gt.json").read_text())
    assert len(gt) == 2 and len(list((scene / "rgb").glob("*.png"))) == 2


def test_rotating_object_example(tmp_path):
    pytest.importorskip("cv2")
    out = tmp_path / "spin.mp4"
    frames = load("torch_rotating_object").main(None, str(out), n_frames=3, size=32, device="cpu")
    assert frames.shape == (3, 32, 32, 3) and frames.dtype == np.uint8
    assert (frames[0] != frames[2]).any()  # the box turned
    assert os.path.getsize(out) > 0


def test_reconstruct_asset_example(tmp_path):
    asset = load("torch_reconstruct_asset").main(tmp_path, iterations=20, size=48, n_images=6,
                                                 n_seeds=600, device="cpu")
    assert Path(asset.gaussian_point_cloud_path(20)).exists()
    assert Path(asset.urdf_obj_path).exists()
    assert "scanned_box.obj" in Path(asset.urdf_file_path).read_text()
    assert "COLMAP_STUB_MODEL" not in os.environ  # the demo restores the environment
