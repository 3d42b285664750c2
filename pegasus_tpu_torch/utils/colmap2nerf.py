"""Copied verbatim from ``pegasus_tpu/utils/colmap2nerf.py``; only the import lines differ.

COLMAP -> instant-ngp ``transforms.json`` converter.

Functional equivalent of the reference's vendored NVIDIA script
(reference: src/utility/colmap2nerf.py:114-565, entry
``convert_colmap2nerf``): read a COLMAP model, compute per-image c2w
matrices in the NeRF convention (flip y/z), center and scale the scene,
write transforms.json.  Reads binary models directly (the reference needs
a text export first).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from pegasus_tpu_torch.io import colmap as cio
from pegasus_tpu_torch.utils.pose import qvec2rotmat


def convert_colmap2nerf(
    sparse_dir,
    images_dir: str = "images",
    out_path=None,
    aabb_scale: int = 16,
    keep_world_scale: bool = False,
) -> dict:
    sparse_dir = Path(sparse_dir)
    cams = cio.read_cameras_binary(sparse_dir / "cameras.bin")
    images = cio.read_images_binary(sparse_dir / "images.bin")

    intr = cams[min(cams.keys())]
    fx, fy, cx, cy = cio.colmap_intrinsics(intr)
    angle_x = 2 * math.atan(intr.width / (2 * fx))
    angle_y = 2 * math.atan(intr.height / (2 * fy))

    # COLMAP w2c -> c2w, then flip to the NeRF/OpenGL camera convention
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = []
    for im in sorted(images.values(), key=lambda i: i.name):
        R = qvec2rotmat(im.qvec)
        t = np.asarray(im.tvec)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        c2w = c2w @ flip
        frames.append(
            {
                "file_path": f"{images_dir}/{im.name}",
                "transform_matrix": c2w.tolist(),
            }
        )

    if not keep_world_scale and frames:
        centers = np.array([f["transform_matrix"] for f in frames])[:, :3, 3]
        offset = centers.mean(axis=0)
        scale = 1.0
        spread = np.linalg.norm(centers - offset, axis=1).mean()
        if spread > 0:
            scale = 4.0 / spread  # instant-ngp's preferred unit-ish scale
        for f in frames:
            m = np.asarray(f["transform_matrix"])
            m[:3, 3] = (m[:3, 3] - offset) * scale
            f["transform_matrix"] = m.tolist()

    out = {
        "camera_angle_x": angle_x,
        "camera_angle_y": angle_y,
        "fl_x": fx,
        "fl_y": fy,
        "cx": cx,
        "cy": cy,
        "w": intr.width,
        "h": intr.height,
        "aabb_scale": aabb_scale,
        "frames": frames,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out
