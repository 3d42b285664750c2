"""The periphery on the card: a training step that is bitwise repeatable,
the wire viewer's frames, and an asset recipe end to end.

    python -m pytest -m gpu tests/test_torch_gui_card.py

Needs a CUDA device and ``nvcc`` and imports nothing of JAX.  Gates:

* two ``train_step``s from one state give bitwise-equal parameters, Adam
  moments and densify statistics: no float of the step is summed by an
  atomic (the backward's scatter to splats is a segmented sum in a fixed
  order);
* each frame ``network_gui.gaussian_splatting_viewer`` serves equals the
  uint8 of ``rasterize`` of the same camera called directly, bitwise (the
  same kernel on the same bins);
* ``hemispherical_object_reconstruction`` at 128x128 for 60 iterations
  with a stub ``colmap``: every stage recorded, the backward kernel
  launched once per iteration, the trained and cleaned ply, mesh and URDF
  written, the cleaned cloud recentred by the URDF's translation.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from pegasus_tpu_torch import network_gui as ng
from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.ply import load_gs_ply, save_gs_ply
from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.testing import install_colmap_stub, make_box_cloud, write_colmap_scan
from pegasus_tpu_torch.training.trainer import GROUPS, GSTrainer, TrainConfig, init_from_points

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def box(device, n=20_000):
    return make_box_cloud(np.random.default_rng(7), n=n, half_extents=(0.15, 0.15, 0.18),
                          rgb=(0.6, 0.4, 0.3), object_id=0, device=device)


@pytest.mark.parametrize("abs_grad", [False, True])
def test_train_step_is_bitwise_repeatable(cuda, abs_grad):
    gt_cloud = box(cuda)
    cam = Camera.look_at((0.6, 0.45, 0.5), (0, 0, 0), (0, 0, 1), np.deg2rad(55), np.deg2rad(55),
                         256, 256, device=cuda)
    with torch.no_grad():
        gt = rasterize(gt_cloud, cam, max_objects=1).rgb.clamp(0, 1)
    rng = np.random.default_rng(3)
    idx = rng.choice(gt_cloud.num_splats, 8000, replace=False)
    pts = gt_cloud.xyz[idx].cpu().numpy() + rng.normal(size=(8000, 3)) * 0.005
    config = TrainConfig(capacity=20_000, densify_abs_grad=abs_grad)
    trainer = GSTrainer(config, width=256, height=256, device=cuda)
    state = trainer.init_state(init_from_points(pts, np.full((8000, 3), 0.5), config, device=cuda))
    state, _ = trainer.train_step(state, cam, gt)  # moments and statistics not all zero
    a, _ = trainer.train_step(state, cam, gt)
    b, _ = trainer.train_step(state, cam, gt)
    torch.cuda.synchronize()
    for g in GROUPS:
        assert torch.equal(getattr(a.cloud, g), getattr(b.cloud, g)), g
        assert torch.equal(a.mu[g], b.mu[g]) and torch.equal(a.nu[g], b.nu[g]), g
    assert torch.equal(a.xyz_grad_accum, b.xyz_grad_accum) and torch.equal(a.denom, b.denom)
    assert float(a.xyz_grad_accum.abs().sum()) > 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed mid-message"
        buf += chunk
    return buf


def test_viewer_frames_equal_rasterize(cuda, tmp_path):
    from pegasus_tpu_torch.viewer import orbit_cameras

    ply = tmp_path / "point_cloud.ply"
    save_gs_ply(box("cpu"), str(ply))
    cloud = load_gs_ply(str(ply), device=cuda)
    cams = orbit_cameras(center=(0, 0, 0), radius=0.8, n_views=3, width=320, height=240,
                         device=cuda)
    port = _free_port()
    served = {}
    th = threading.Thread(target=lambda: served.update(n=ng.gaussian_splatting_viewer(
        str(ply), ip="127.0.0.1", port_=port, max_frames=len(cams), device=cuda)), daemon=True)
    rasterize_cuda.composite_tiles.launches = 0
    th.start()
    end = time.time() + 120
    while True:
        try:
            client = socket.create_connection(("127.0.0.1", port), timeout=120)
            break
        except OSError:
            assert time.time() < end
            time.sleep(0.02)
    try:
        for cam in cams:
            client.sendall(ng.request_message(cam))
            got = _recv_exact(client, 320 * 240 * 3)
            verify = _recv_exact(client, int.from_bytes(_recv_exact(client, 4), "little"))
            assert verify.decode("ascii") == str(ply)
            assert got == ng.frame_bytes(rasterize(cloud, cam, max_objects=1).rgb)
    finally:
        client.close()
        th.join(timeout=120)
    assert served.get("n") == len(cams)
    assert rasterize_cuda.composite_tiles.launches == 2 * len(cams)  # served + direct


def test_hemispherical_recipe_on_card(cuda, tmp_path, monkeypatch):
    from pegasus_tpu_torch.assets.registry import Asset
    from pegasus_tpu_torch.gs.ply import read_ply_vertex_data
    from pegasus_tpu_torch.io.mesh import load_mesh
    from pegasus_tpu_torch.reconstruction.recipes import hemispherical_object_reconstruction

    scan = tmp_path / "scan"
    write_colmap_scan(scan, box(cuda), 128, n_images=12, n_seeds=4000)
    data = tmp_path / "data"
    up = data / "object" / "scanned_box" / "up"
    up.mkdir(parents=True)
    os.rename(scan / "images", up / "images")
    install_colmap_stub(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    monkeypatch.setenv("COLMAP_STUB_MODEL", str(scan / "sparse" / "0"))

    asset = Asset(OBJECT_NAME="scanned_box", ID=901, dataset_path=str(data), SCALE=False,
                  ALPHA=0.05)
    composite_vjp.composite_tiles_backward.launches = 0
    hemispherical_object_reconstruction(asset, train_iterations=60)
    assert composite_vjp.composite_tiles_backward.launches == 60
    assert json.loads((up / "stages.json").read_text()) == {
        "feature_extractor": True, "matcher": True, "mapper": True}
    cleaned = read_ply_vertex_data(asset.gaussian_point_cloud_path(60))
    o3d = read_ply_vertex_data(asset.gs_o3d_point_cloud_path(60))
    assert len(cleaned["x"]) == len(o3d["x"]) >= 4000
    mesh = load_mesh(asset.urdf_obj_path)
    assert len(mesh.faces) > 100
    assert "scanned_box.obj" in open(asset.urdf_file_path).read()
    # gs_cleaning moved the cloud by the mesh's recentring translation
    shift = -mesh_center(asset, o3d)
    moved = np.stack([cleaned[k] for k in "xyz"], 1).mean(0)
    raw = np.stack([o3d[k] for k in "xyz"], 1).mean(0)
    np.testing.assert_allclose(moved - raw, shift, atol=1e-5)


def mesh_center(asset, o3d):
    """The vertex mean of the alpha-shape mesh of the trained cloud: the
    translation ``URDFGenerator`` removes (recomputed from the o3d ply)."""
    from pegasus_tpu_torch.reconstruction.urdf_gen import alpha_shape_mesh

    pts = np.stack([o3d[k] for k in "xyz"], 1).astype(np.float64)
    return alpha_shape_mesh(pts, asset.ALPHA).vertices.mean(axis=0)
