"""The repaired public surface on the card.

    python -m pytest -m gpu tests/test_torch_api_card.py

Needs a CUDA device and ``nvcc`` and imports nothing of JAX.  Gates:

* ``GSTrainer(config, None, W, H)``, the reference's positional form,
  takes one ``train_step`` on ``cuda`` bitwise equal to the keyword form's
  from the same state: every parameter, Adam moment and densify statistic;
* importing ``pegasus_tpu_torch`` and every subpackage in a fresh
  interpreter leaves ``torch.cuda.is_initialized()`` False.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.testing import make_box_cloud
from pegasus_tpu_torch.training.trainer import GROUPS, GSTrainer, TrainConfig, init_from_points

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def test_reference_positional_trainer_steps_as_the_keyword_form(cuda):
    gt_cloud = make_box_cloud(np.random.default_rng(7), n=20_000, half_extents=(0.15, 0.15, 0.18),
                              rgb=(0.6, 0.4, 0.3), object_id=0, device=cuda)
    cam = Camera.look_at((0.6, 0.45, 0.5), (0, 0, 0), (0, 0, 1), np.deg2rad(55), np.deg2rad(55),
                         192, 160, device=cuda)
    with torch.no_grad():
        gt = rasterize(gt_cloud, cam, max_objects=1).rgb.clamp(0, 1)
    rng = np.random.default_rng(3)
    idx = rng.choice(gt_cloud.num_splats, 8000, replace=False)
    pts = gt_cloud.xyz[idx].cpu().numpy() + rng.normal(size=(8000, 3)) * 0.005
    config = TrainConfig(capacity=20_000)
    by_keyword = GSTrainer(config, width=192, height=160, device=cuda)
    by_position = GSTrainer(config, None, 192, 160, device=cuda)
    assert (by_position.width, by_position.height, by_position.backend) == (192, 160, "pallas")
    state = by_keyword.init_state(init_from_points(pts, np.full((8000, 3), 0.5), config, device=cuda))
    state, _ = by_keyword.train_step(state, cam, gt)  # moments and statistics not all zero
    a, _ = by_keyword.train_step(state, cam, gt)
    b, _ = by_position.train_step(state, cam, gt)
    torch.cuda.synchronize()
    for g in GROUPS:
        assert torch.equal(getattr(a.cloud, g), getattr(b.cloud, g)), g
        assert torch.equal(a.mu[g], b.mu[g]) and torch.equal(a.nu[g], b.nu[g]), g
    assert torch.equal(a.xyz_grad_accum, b.xyz_grad_accum) and torch.equal(a.denom, b.denom)
    assert torch.equal(a.max_radii2d, b.max_radii2d) and (a.count, a.step) == (b.count, b.step)
    assert float(a.xyz_grad_accum.abs().sum()) > 0


def test_importing_the_port_leaves_cuda_uninitialised(cuda):
    code = ("import importlib, pkgutil, torch\n"
            "import pegasus_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'pegasus_tpu_torch.') if m.ispkg]\n"
            "[importlib.import_module(n) for n in names]\n"
            "assert len(names) >= 10, names\n"
            "assert torch.cuda.is_available()\n"
            "assert not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
