"""Frozen copy of pegasus_tpu_torch/scene/camera_trajectory.py at commit 7a69f88.

Camera trajectory sampling from COLMAP reconstruction poses.

Port of ``pegasus_tpu/scene/camera_trajectory.py``: the same numpy code,
building this package's ``Camera`` on ``device``.

Reproduces the reference's trajectory generator
(reference: src/gs/pegasus_setup.py:85-143): pick a random start among the
environment's registered COLMAP images, then SLERP/lerp-interpolate between
consecutive poses.  The interpolated entity is the reference's hybrid
matrix [R_c2w | t_w2c] — we keep that convention exactly so trajectories
match, and convert to proper cameras at the end.

Modes: 'random' (random start window), 'sequence' (start at 0),
'random+zoom' (random radial scaling of the translation, matching the
reference's in-place ``pose1`` scaling quirk at pegasus_setup.py:101-111).
"""

from __future__ import annotations

from typing import List, Literal

import numpy as np

from reference.frozen.camera import Camera
from reference.frozen.device import DEFAULT_DEVICE
from reference.frozen.utils.pose import focal2fov, interpolate_pose, qvec2rotmat


def create_camera_trajectory(
    cam_extr: dict,
    focal_x: float,
    intr_width: int,
    intr_height: int,
    render_width: int,
    render_height: int,
    num_cameras: int = 5,
    num_interpolation_steps: int = 24,
    mode: Literal["random", "sequence", "random+zoom"] = "random",
    rng: np.random.Generator | None = None,
    device=DEFAULT_DEVICE,
) -> List[Camera]:
    """cam_extr: {image_id: ColmapImage}; focal_x: fx from the GS model's
    cameras.json (the reference uses fx for BOTH axes,
    pegasus_setup.py:119-122 — reproduced deliberately)."""
    rng = rng or np.random.default_rng()
    keys = sorted(cam_extr.keys())
    if len(keys) < num_cameras + 1:
        raise ValueError(
            f"need at least {num_cameras + 1} registered poses, got {len(keys)}"
        )

    if mode == "sequence":
        start_frame = 0
    else:
        start_frame = int(rng.integers(0, len(keys) - num_cameras))

    fovy = focal2fov(focal_x, intr_height)
    fovx = focal2fov(focal_x, intr_width)

    cams: List[Camera] = []
    for pose_idx in range(start_frame, start_frame + num_cameras):
        idx = keys[pose_idx]
        idx_next = keys[pose_idx + 1]

        pose1 = np.eye(4)
        pose1[:3, :3] = qvec2rotmat(cam_extr[idx].qvec).T
        pose1[:3, 3] = np.asarray(cam_extr[idx].tvec)
        if mode == "random+zoom":
            pose1[:3, 3] *= rng.uniform(0.6, 1.0)

        pose2 = np.eye(4)
        pose2[:3, :3] = qvec2rotmat(cam_extr[idx_next].qvec).T
        pose2[:3, 3] = np.asarray(cam_extr[idx_next].tvec)
        if mode == "random+zoom":
            pose1[:3, 3] *= rng.uniform(0.6, 1.0)

        for alpha in np.linspace(0, 1, num_interpolation_steps + 1)[:-1]:
            T = interpolate_pose(t=alpha, t1=0.0, pose1=pose1, t2=1.0, pose2=pose2)
            cams.append(
                Camera.from_inria(
                    R=T[:3, :3],
                    T=T[:3, 3],
                    FoVx=fovx,
                    FoVy=fovy,
                    width=render_width,
                    height=render_height,
                    device=device,
                )
            )
    return cams
