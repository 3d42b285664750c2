"""The scale-out paths on lanes of the card: the splat-sharded render, the
data-parallel train step and a sharded generation with its writers.

    python -m pytest -m gpu tests/test_torch_parallel_card.py

Needs a CUDA device and ``nvcc`` and imports nothing of JAX (the GPU machine
has none).  The lanes are one card listed several times, each with a stream
of its own; the compositor kernels launch on the lane's stream.  Tolerances:
the sharded render (backend "cuda": one kernel launch per shard) against the
unsharded ``rasterize`` and the golden compositor 1e-5 in every field, two
renders on one mesh bitwise equal; the DP step against the hand-made batch
update atol 2e-6 on Adam's first moment (linear in the gradient; the update
itself is lr x sign(g) on the first step).
"""

import json

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.eval import check_bop_dataset
from pegasus_tpu_torch.generate import finalize_dataset, run_generation
from pegasus_tpu_torch.gs.cloud import merge
from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs, rasterize_reference
from pegasus_tpu_torch.parallel.mesh import make_mesh
from pegasus_tpu_torch.parallel.sharded_render import (rasterize_splat_sharded,
                                                       rasterize_splat_sharded_batch)
from pegasus_tpu_torch.testing import (build_synthetic_dataset, make_box_cloud,
                                       make_plane_cloud)
from pegasus_tpu_torch.training.trainer import GROUPS, GSTrainer, TrainConfig, init_from_points

pytestmark = pytest.mark.gpu

BG = (0.2, 0.1, 0.3)
K = 4
FIELDS = RenderOutputs._fields


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def scene_and_cam(device, width=160, height=120):
    rng = np.random.default_rng(3)
    env = make_plane_cloud(rng, n=5000, size=1.5, device=device)
    b1 = make_box_cloud(rng, n=2000, center=(0.05, 0, 0.08), object_id=1, device=device)
    b2 = make_box_cloud(rng, n=1600, center=(-0.1, 0.05, 0.05), object_id=2, rgb=(0.2, 0.5, 0.9),
                        half_extents=(0.04, 0.04, 0.05), device=device)
    cam = Camera.look_at(eye=(0.5, 0.4, 0.6), target=(0, 0, 0.05), up=(0, 0, 1), fovx=np.deg2rad(55),
                         fovy=np.deg2rad(45), width=width, height=height, device=device)
    return merge([env, b1, b2]), cam


def max_diff(a, b):
    return max(float((getattr(a, f) - getattr(b, f)).abs().max()) for f in FIELDS)


@pytest.mark.parametrize("n_lanes", [1, 2, 4, 8, 3])
def test_splat_sharded_on_lanes_of_the_card(cuda, n_lanes):
    scene, cam = scene_and_cam(cuda)
    mesh = make_mesh((n_lanes,), ("splat",), [cuda] * n_lanes)
    assert all(lane.stream is not None for lane in mesh.lanes())
    assert len({lane.stream.cuda_stream for lane in mesh.lanes()}) == n_lanes  # a stream each
    before = rasterize_cuda.composite_tiles.launches
    got = rasterize_splat_sharded(scene, cam, mesh, background=BG, max_objects=K, backend="cuda")
    assert rasterize_cuda.composite_tiles.launches == before + n_lanes  # one launch per shard
    assert got.rgb.device == cuda and all(bool(torch.isfinite(x).all()) for x in got)
    with torch.no_grad():
        assert max_diff(rasterize(scene, cam, background=BG, max_objects=K), got) <= 1e-5
        assert max_diff(rasterize_reference(scene, cam, background=BG, max_objects=K), got) <= 1e-5
    again = rasterize_splat_sharded(scene, cam, mesh, background=BG, max_objects=K, backend="cuda")
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    golden = rasterize_splat_sharded(scene, cam, mesh, background=BG, max_objects=K, backend="golden")
    assert max_diff(golden, got) <= 1e-5


def test_hybrid_mesh_and_an_all_padding_shard(cuda):
    scene, cam = scene_and_cam(cuda)
    moved = scene.replace(xyz=scene.xyz + 0.01)
    hybrid = make_mesh((2, 4), ("scene", "splat"), [cuda] * 8)
    batch = rasterize_splat_sharded_batch([scene, moved], [cam, cam], hybrid, cam.width, cam.height,
                                          background=BG, max_objects=K)
    lanes4 = make_mesh((4,), ("splat",), [cuda] * 4)
    for i, cloud in enumerate((scene, moved)):
        own = rasterize_splat_sharded(cloud, cam, lanes4, background=BG, max_objects=K)
        assert all(torch.equal(getattr(batch, f)[i], getattr(own, f)) for f in FIELDS), i
    # a cloud padded to twice its size: the second of two shards is all padding
    one = rasterize_splat_sharded(scene, cam, make_mesh((1,), ("splat",), [cuda]), background=BG,
                                  max_objects=K)
    two = rasterize_splat_sharded(scene.padded(2 * scene.num_splats), cam,
                                  make_mesh((2,), ("splat",), [cuda] * 2), background=BG, max_objects=K)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_dp_step_on_lanes_of_the_card(cuda):
    rng = np.random.default_rng(5)
    gt_cloud = make_box_cloud(rng, n=3000, half_extents=(0.08, 0.08, 0.1), rgb=(0.7, 0.3, 0.2),
                              object_id=0, device=cuda)
    cams, gts = [], []
    with torch.no_grad():
        for az in np.linspace(0, 2 * np.pi, 4, endpoint=False):
            cams.append(Camera.look_at(eye=(0.5 * np.cos(az), 0.5 * np.sin(az), 0.35), target=(0, 0, 0),
                                       up=(0, 0, 1), fovx=np.deg2rad(50), fovy=np.deg2rad(50),
                                       width=96, height=96, device=cuda))
            gts.append(torch.clamp(rasterize(gt_cloud, cams[-1], max_objects=1).rgb, 0, 1))
    config = TrainConfig(capacity=2048, densify_from_iter=10**9)
    trainer = GSTrainer(config, width=96, height=96, device=cuda)
    pts = gt_cloud.xyz[:1000].cpu().numpy() + rng.normal(size=(1000, 3)) * 0.01
    state = trainer.init_state(init_from_points(pts.astype(np.float32), np.full((1000, 3), 0.5, np.float32),
                                                config, device=cuda), spatial_lr_scale=0.5)
    dp_step = trainer.make_dp_train_step(make_mesh((4,), ("batch",), [cuda] * 4))
    fwd, bwd = rasterize_cuda.composite_tiles.launches, composite_vjp.composite_tiles_backward.launches
    got, metrics = dp_step(state, cams, gts)
    assert rasterize_cuda.composite_tiles.launches == fwd + 4  # one pair per camera
    assert composite_vjp.composite_tiles_backward.launches == bwd + 4
    assert (got.step, got.count) == (1, 1)

    grads, losses, g2d_sum, denom_sum = [], [], 0.0, 0.0
    for cam, img in zip(cams, gts):
        loss, _, pg, og = trainer._loss_and_grads(state, cam, img)
        g2d, denom = trainer._densify_stats(og)
        grads.append(pg)
        losses.append(float(loss))
        g2d_sum, denom_sum = g2d_sum + g2d, denom_sum + denom
    want = trainer._apply_grads(state, {g: sum(pg[g] for pg in grads) / 4.0 for g in GROUPS},
                                g2d_sum, denom_sum)
    for g in GROUPS:
        torch.testing.assert_close(got.mu[g], want.mu[g], rtol=1e-4, atol=2e-6)
    torch.testing.assert_close(got.xyz_grad_accum, want.xyz_grad_accum, rtol=1e-3, atol=1e-7)
    assert torch.equal(got.denom, want.denom)
    assert abs(float(metrics["loss"]) - np.mean(losses)) <= 1e-6
    first = float(metrics["loss"])
    for _ in range(15):
        got, metrics = dp_step(got, cams, gts)
    assert float(metrics["loss"]) < first


def test_sharded_generation_on_lanes_of_the_card(cuda, tmp_path):
    """Six scenes on 4 lanes (a full batch and a short one), 128x96, a drop
    of 60 replayed steps: one launch per scene (its 3 frames are one chunk
    at the default ``frame_chunk``), the dataset check
    passes on what the writers got from the lanes, and a second call resumes."""
    build_synthetic_dataset(tmp_path / "data", env_splats=20_000, obj_splats=3_000)
    data = tmp_path / "data"
    env = Asset(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(data),
                DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3))
    objs = [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(data))
            for n, i in (("cup_noodles_04", 104), ("cup_noodles_07", 107))]
    config = GenerationConfig(
        dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
        dataset_base_path=str(tmp_path / "out"), dataset_name="card", num_scenes=6, min_num_objects=1,
        max_num_objects=2, mode="dynamic", render_width=128, render_height=96, num_cameras=1,
        num_camera_interpolation_steps=3, camera_trajectory_mode="random", simulation_steps=60,
        save_video=False, seed=4)
    before = rasterize_cuda.composite_tiles.launches
    stats = run_generation(config, [env], objs, mesh=make_mesh(devices=[cuda] * 4))
    assert rasterize_cuda.composite_tiles.launches == before + 6 * 1
    assert [b["scene_ids"] for b in stats.batches] == [[1, 2, 3, 4], [5, 6]]
    finalize_dataset(config)
    report = check_bop_dataset(tmp_path / "out", "card")
    assert report["ok"], report["errors"]
    gt = json.loads((tmp_path / "out" / "card" / "train" / "000005" / "scene_gt.json").read_text())
    assert sorted(gt) == ["0", "1", "2"]
    assert run_generation(config, [env], objs, mesh=make_mesh(devices=[cuda] * 4)).records == []
