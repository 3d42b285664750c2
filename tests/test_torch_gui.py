"""Port parity: the SIBR wire viewer (``network_gui``), ``publish2gui``, the
trainer's GUI hook and ``viewer.py`` of ``pegasus_tpu_torch`` against
``pegasus_tpu``, on the pattern of ``tests/test_network_gui.py``: a client
socket on localhost at an ephemeral port, no viewer binary; the port runs on
the CPU.

Tolerances: the decoded camera to 1e-6 (the same float32 values, the same
arithmetic); a served frame >= 40 dB against the JAX package's golden
compositor (the port serves the forward compositor's render, truncated to
uint8 like the reference's); ``orbit_cameras`` exactly equal (the same
float64 numpy arithmetic, then float32); a generation run with the GUI
writes the same bytes as one without.
"""

import filecmp
import io
import json
import os
import socket
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from pegasus_tpu import network_gui as jng
from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.ply import load_gs_ply as j_load_ply
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.viewer import orbit_cameras as j_orbit_cameras

from pegasus_tpu_torch import network_gui as ng
from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.ply import save_gs_ply
from pegasus_tpu_torch.interop import CAMERA_FIELDS, camera_from_numpy
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.testing import build_synthetic_dataset, make_box_cloud
from pegasus_tpu_torch.viewer import orbit_cameras, render_turntable, serve_viewer

torch.set_num_threads(1)
CPU = "cpu"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def connect(port: int, deadline_s: float = 120.0) -> socket.socket:
    """A client socket, retried until the server's listener is up."""
    end = time.time() + deadline_s
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=120)
        except OSError:
            if time.time() > end:
                raise
            time.sleep(0.02)


def recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed mid-message"
        buf += chunk
    return buf


def read_reply(sock, w: int, h: int):
    """(image or None, verify string) of one server reply."""
    img = np.frombuffer(recv_exact(sock, w * h * 3), np.uint8).reshape(h, w, 3) if w else None
    n = int.from_bytes(recv_exact(sock, 4), "little")
    return img, recv_exact(sock, n).decode("ascii")


def front_camera(w, h):
    """Looking at the origin from (0, 0, 1.2), as the reference's tests do."""
    return Camera.create(np.diag([1.0, -1.0, -1.0]), [0, 0, 1.2], 1.0, 0.8, w, h, device=CPU)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse) if mse > 0 else np.inf


@pytest.fixture
def gui():
    yield ng
    ng.close()


def test_wire_roundtrip(gui):
    ng.init("127.0.0.1", 0)
    client = socket.create_connection(("127.0.0.1", ng.listener.getsockname()[1]), timeout=60)
    ng.try_connect()
    assert ng.conn is not None

    cam = front_camera(32, 24)
    client.sendall(ng.request_message(cam, scaling_modifier=0.5))
    got, do_training, shs, rot, keep_alive, scaling = ng.receive(CPU)
    assert (got.width, got.height) == (32, 24) and got.device.type == "cpu"
    assert torch.equal(got.R_w2c, cam.R_w2c) and torch.equal(got.t_w2c, cam.t_w2c)
    assert (not do_training, not shs, not rot, keep_alive, scaling) == (True, True, True, True, 0.5)

    img = (np.random.default_rng(0).random((24, 32, 3)) * 255).astype(np.uint8)
    ng.serve_frame(img, verify="model_path")
    back, verify = read_reply(client, 32, 24)
    np.testing.assert_array_equal(back, img)
    assert verify == "model_path"

    client.sendall(ng.request_message(None, train=True))  # resolution 0: no camera
    cam2, do_training, *_ = ng.receive(CPU)
    assert cam2 is None and do_training
    client.close()


def test_camera_decode_matches_jax(rng):
    for _ in range(4):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        cam = Camera.create(
            R, t, float(rng.uniform(0.5, 1.2)), float(rng.uniform(0.5, 1.2)), 40, 30, device=CPU)
        msg = json.loads(ng.request_message(cam)[4:])
        mine, ref = ng.camera_from_message(msg, device=CPU), jng.camera_from_message(msg)
        np.testing.assert_allclose(mine.R_w2c.numpy(), np.asarray(ref.R_w2c), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(mine.t_w2c.numpy(), np.asarray(ref.t_w2c), atol=1e-6, rtol=1e-6)
        assert (mine.fovx, mine.fovy) == (float(ref.fovx), float(ref.fovy))
        assert (mine.width, mine.height) == (ref.width, ref.height)
        np.testing.assert_allclose(mine.R_w2c.numpy(), R, atol=1e-6)  # the encoding inverts


def test_viewer_serves_frames_against_golden(tmp_path, gui):
    """gaussian_splatting_viewer: two 40x30 frames of one ply, each >= 40 dB
    against the JAX package's golden render of the same ply and camera;
    the verify string is the ply path."""
    ply = tmp_path / "point_cloud.ply"
    save_gs_ply(make_box_cloud(np.random.default_rng(1), n=300, rgb=(0.8, 0.2, 0.2),
                               object_id=0, device=CPU), str(ply))
    port = free_port()
    result = {}
    th = threading.Thread(target=lambda: result.update(served=ng.gaussian_splatting_viewer(
        str(ply), ip="127.0.0.1", port_=port, max_frames=2, device=CPU)), daemon=True)
    th.start()
    client = connect(port)
    jcloud = j_load_ply(str(ply))
    for eye in ((0.0, 0.0, 1.2), (0.3, -0.2, 0.5)):
        jcam = JCamera.look_at(eye, (0, 0, 0), (0, 1, 0) if eye[0] == 0 else (0, 0, 1),
                               1.0, 0.8, 40, 30)
        cam = camera_from_numpy({f: np.asarray(getattr(jcam, f)) for f in CAMERA_FIELDS},
                                device=CPU)
        client.sendall(ng.request_message(cam))
        img, verify = read_reply(client, 40, 30)
        assert verify == str(ply)
        golden = (np.clip(np.asarray(j_reference(jcloud, jcam).rgb), 0, 1) * 255).astype(np.uint8)
        assert img.mean() > 1 and psnr(img, golden) >= 40
    client.close()
    th.join(timeout=120)
    assert result.get("served") == 2


def _pegasus(root, out, gui_on: bool):
    env = Asset(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                DROP_REGION=(0.05, 0.05), DROP_HEIGHT=(0.2, 0.25))
    objs = [Asset(OBJECT_NAME="cup_noodles_04", ID=104, dataset_path=str(root))]
    peg = PEGASUS(
        dataset_path=str(root), env_dataset_path=str(root), urdf_asset_folder=str(root / "urdf"),
        gs_env_list=[env], gs_object_list=objs, render_height=40, render_width=48,
        num_cameras=1, simulation_steps=20, num_camera_interpolation_steps=4, mode="static",
        camera_trajectory_mode="sequence", dataset_base_path=str(out), seed=1,
        publish2gui=gui_on, QUIET=True, device=CPU, frame_chunk=2,
    )
    return peg, env, objs


def test_publish2gui_serves_during_generation(tmp_path, gui, monkeypatch):
    """PEGASUS(publish2gui=True) answers requests queued before the frame
    loop, one per chunk (4 frames in chunks of 2), and writes the same BOP
    tree as a run without it."""
    root = tmp_path / "data"
    build_synthetic_dataset(root, object_names=("cup_noodles_04",), env_splats=512,
                            obj_splats=128)
    monkeypatch.setattr(PEGASUS, "PORT", 0)  # ephemeral
    trees = {}
    for gui_on in (False, True):
        out = tmp_path / f"out_{gui_on}"
        peg, env, objs = _pegasus(root, out, gui_on)
        client = None
        if gui_on:
            client = socket.create_connection(("127.0.0.1", ng.listener.getsockname()[1]),
                                              timeout=120)
            cam = front_camera(32, 24)
            client.sendall(ng.request_message(cam) * 2)  # two requests, queued
        peg.init_bullet([env], objs, "gui_run", 1, 1, 1, random=False)
        peg.init("gui_run", 1)
        peg.init_start_position()
        peg.generate_dataset(["rgb", "depth", "seg_vis"], save_bop=True, save_video=False)
        peg.save2bop()
        trees[gui_on] = out / "gui_run" / "train" / "000001"
        if gui_on:
            for _ in range(2):
                img, verify = read_reply(client, 32, 24)
                assert img.shape == (24, 32, 3) and verify == str(root)
            client.close()
    cmp = filecmp.dircmp(trees[False], trees[True])
    files = [p.relative_to(trees[False]) for p in trees[False].rglob("*") if p.is_file()]
    assert len(files) > 4
    _, mismatch, errors = filecmp.cmpfiles(trees[False], trees[True], files, shallow=False)
    assert not mismatch and not errors and not cmp.left_only and not cmp.right_only


def _colmap_scene(root: Path):
    """A tiny COLMAP scene: 4 hemisphere views of a box at 32x32."""
    from pegasus_tpu_torch.io import colmap as cio
    from pegasus_tpu_torch.io.png import write_png
    from pegasus_tpu_torch.ops.rasterize_ref import rasterize_reference
    from pegasus_tpu_torch.testing import make_colmap_hemisphere
    from pegasus_tpu_torch.utils.pose import focal2fov

    cams, images = make_colmap_hemisphere(n_images=4, radius=0.5, width=32, height=32, focal=40.0)
    gt = make_box_cloud(np.random.default_rng(3), n=200, half_extents=(0.07, 0.07, 0.09),
                        rgb=(0.7, 0.3, 0.2), object_id=0, device=CPU)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    cio.write_cameras_binary(cams, sparse / "cameras.bin")
    cio.write_images_binary(images, sparse / "images.bin")
    xyz = gt.xyz.numpy()[::4]
    none = np.zeros(0, np.int32)
    cio.write_points3d_binary(
        {i: cio.ColmapPoint3D(i, xyz[i], np.array([150, 80, 60], np.uint8), 0.1, none, none)
         for i in range(len(xyz))}, sparse / "points3D.bin")
    (root / "images").mkdir()
    fov = focal2fov(40.0, 32)
    for im in images.values():
        cam = Camera.from_colmap(im.qvec, im.tvec, fov, fov, 32, 32, device=CPU)
        rgb = rasterize_reference(gt, cam, max_objects=1).rgb.clamp(0, 1)
        write_png(root / "images" / im.name, (rgb * 255).to(torch.uint8).numpy())


def test_gui_serves_during_training(tmp_path, gui):
    """train_gaussian_splatting_wrapper(gui=True): two renders of the cloud
    in training, then ``train=True`` releases the hook; the trained cloud
    equals a run without the GUI exactly (the renders change nothing)."""
    from pegasus_tpu_torch.training.trainer import train_gaussian_splatting_wrapper

    _colmap_scene(tmp_path)
    port = free_port()
    kw = dict(TEST_ITERATION=(3,), SAVE_ITERATION=(3,), iterations=3, capacity=512, device=CPU)
    result = {}
    th = threading.Thread(target=lambda: result.update(state=train_gaussian_splatting_wrapper(
        str(tmp_path), str(tmp_path / "model"), gui=True, ip="127.0.0.1", port=port, **kw)),
        daemon=True)
    th.start()
    client = connect(port)
    cam = front_camera(32, 24)
    client.sendall(ng.request_message(cam))
    img, verify = read_reply(client, 32, 24)
    assert verify == str(tmp_path / "model") and img.mean() > 0.5
    client.sendall(ng.request_message(cam, train=True))  # a render, then back to training
    img2, _ = read_reply(client, 32, 24)
    np.testing.assert_array_equal(img2, img)  # still iteration 1
    client.close()
    th.join(timeout=300)
    assert not th.is_alive()
    assert (tmp_path / "model" / "point_cloud" / "iteration_3" / "point_cloud.ply").exists()
    plain = train_gaussian_splatting_wrapper(str(tmp_path), str(tmp_path / "model_plain"), **kw)
    for f in ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot", "alive"):
        assert torch.equal(getattr(result["state"].cloud, f), getattr(plain.cloud, f)), f


def test_orbit_cameras_equal_jax():
    kw = dict(center=(0.1, -0.2, 0.05), radius=0.7, elevation_deg=25.0, n_views=7, width=48,
              height=36, fov_deg=45.0)
    for mine, ref in zip(orbit_cameras(**kw, device=CPU), j_orbit_cameras(**kw)):
        np.testing.assert_array_equal(mine.R_w2c.numpy(), np.asarray(ref.R_w2c))
        np.testing.assert_array_equal(mine.t_w2c.numpy(), np.asarray(ref.t_w2c))
        assert (mine.fovx, mine.fovy) == (float(ref.fovx), float(ref.fovy))
        assert (mine.width, mine.height) == (ref.width, ref.height)


def test_turntable_and_live_viewer(tmp_path):
    pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    cloud = make_box_cloud(np.random.default_rng(2), n=128, device=CPU)
    out = render_turntable(cloud, str(tmp_path / "turn.mp4"), n_views=4, width=32, height=32)
    assert os.path.getsize(out) > 1000

    server = serve_viewer(cloud, host="127.0.0.1", port=0, width=32, height=32, blocking=False)
    try:
        port = server.server_address[1]
        html = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60).read()
        assert b"viewer" in html
        jpg = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame?az=30&el=20&r=0.8",
                                     timeout=60).read()
        assert jpg[:2] == b"\xff\xd8"  # JPEG magic
    finally:
        server.shutdown()


def test_viewer_refuses_rasterize_fn(tmp_path):
    """The viewer's entry points take the reference's ``rasterize_fn``, as
    ``PEGASUS`` does: a given function is the one that renders, called as
    the reference calls it, ``rasterize_fn(cloud, cam, background=)``."""
    cloud = make_box_cloud(np.random.default_rng(3), n=16, device=CPU)
    calls = []

    def red(c, cam, background):
        calls.append(background)
        out = rasterize(c, cam, background=background, max_objects=1)
        return out._replace(rgb=torch.zeros_like(out.rgb) + torch.tensor([1.0, 0.0, 0.0]))

    path = render_turntable(cloud, str(tmp_path / "turn.mp4"), n_views=2, width=32, height=32,
                            rasterize_fn=red)
    assert Path(path).stat().st_size > 0 and calls == [(1.0, 1.0, 1.0)] * 2
    server = serve_viewer(cloud, port=0, width=32, height=32, rasterize_fn=red, blocking=False)
    try:
        port = server.server_address[1]
        jpg = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame?az=30&el=20&r=0.8",
                                     timeout=60).read()
        from PIL import Image

        rgb = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB")).astype(int)
        assert abs(rgb[..., 0] - 255).max() <= 8 and rgb[..., 1:].max() <= 8  # the given red
        assert len(calls) == 3
    finally:
        server.shutdown()
