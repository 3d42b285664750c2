"""Copied from ``pegasus_tpu/scene/dataset.py``; images are read with ``io/png.py::read_png`` instead of imageio, and cameras are built on ``device``.

Training-scene loading: COLMAP reconstruction -> cameras + gt images.

Replacement for the Inria ``scene.Scene``/dataset readers consumed by the
reference's training wrapper (reference: src/gs/gs_training.py:46-47).
Reads a standard COLMAP layout:

    <data_path>/sparse/0/{cameras.bin, images.bin, points3D.bin}
    <data_path>/images/<image name>
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.device import DEFAULT_DEVICE
from pegasus_tpu_torch.io import colmap as colmap_io
from pegasus_tpu_torch.io.png import read_png
from pegasus_tpu_torch.utils.pose import focal2fov


def load_colmap_scene(
    data_path: str,
    images_dir: str = "images",
    downscale: int = 1,
    max_images: int | None = None,
    device=DEFAULT_DEVICE,
):
    """Returns dict(points, colors, cameras, images, width, height, extent)."""
    root = Path(data_path)
    sparse = root / "sparse" / "0"
    cams = colmap_io.read_cameras_binary(sparse / "cameras.bin")
    imgs = colmap_io.read_images_binary(sparse / "images.bin")
    try:
        pts = colmap_io.read_points3d_binary(sparse / "points3D.bin")
    except FileNotFoundError:
        pts = {}

    if pts:
        points = np.stack([p.xyz for p in pts.values()])
        colors = np.stack([p.rgb for p in pts.values()]).astype(np.float32) / 255.0
    else:
        points = np.zeros((0, 3))
        colors = np.zeros((0, 3), np.float32)

    cameras, images = [], []
    keys = sorted(imgs.keys())
    if max_images:
        keys = keys[:max_images]
    width = height = None
    for k in keys:
        im = imgs[k]
        intr = cams[im.camera_id]
        fx, fy, _, _ = colmap_io.colmap_intrinsics(intr)
        img_path = root / images_dir / im.name
        arr = np.asarray(read_png(img_path), np.float32) / 255.0
        if downscale > 1:
            arr = arr[::downscale, ::downscale]
        images.append(arr[..., :3])
        # render at the on-disk image size — images are often stored
        # pre-downscaled relative to the COLMAP intrinsics (the
        # reference's ImageMagick resize pyramid, convert.py:90-122);
        # fov is resolution-invariant so only width/height change
        h, w = arr.shape[:2]
        width, height = w, h
        cameras.append(
            Camera.from_colmap(
                im.qvec, im.tvec,
                fovx=focal2fov(fx, intr.width),
                fovy=focal2fov(fy, intr.height),
                width=w, height=h,
                device=device,
            )
        )

    centers = np.stack([c.camera_center.cpu().numpy() for c in cameras])
    extent = float(np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1

    return {
        "points": points,
        "colors": colors,
        "cameras": cameras,
        "images": images,
        "width": width,
        "height": height,
        "extent": max(extent, 1e-3),
    }
