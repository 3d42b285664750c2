"""Copied from ``pegasus_tpu/compat_utils.py``; only the import lines differ (``focal2fov`` / ``fov2focal`` come from ``utils/pose.py``).

Inria GS-submodule utility surface (SURVEY §2.3.4 tail).

The reference imports these helpers from its gaussian-splatting submodule
(reference: src/gs/gaussian_model.py:27-32 pulls safe_state /
inverse_sigmoid / get_expon_lr_func / build_rotation / strip_symmetric /
build_scaling_rotation / mkdir_p; src/gs/pegasus_setup.py and the camera
stack consume getWorld2View2 / BasicPointCloud / geom_transform_points /
focal2fov / fov2focal).  The submodule is not in the checkout, so each
contract here is re-derived from its call sites and the public Inria
semantics, implemented over NumPy (host-side config/setup code — the
device path uses pegasus_tpu_torch's tensor code instead).
"""

from __future__ import annotations

import os
import random
from typing import NamedTuple

import numpy as np

from pegasus_tpu_torch.utils.pose import focal2fov, fov2focal  # noqa: F401 (re-export)


class BasicPointCloud(NamedTuple):
    """Seed point cloud for create_from_pcd (points/colors/normals)."""

    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


def mkdir_p(path) -> None:
    os.makedirs(path, exist_ok=True)


def safe_state(silent: bool = False, seed: int = 0) -> None:
    """Deterministic host RNG state (the reference also silences stdout
    and pins torch's generators; here numpy/random are the host RNGs)."""
    random.seed(seed)
    np.random.seed(seed)
    if silent:
        import sys

        sys.stdout = open(os.devnull, "w")  # noqa: SIM115 — match reference


def inverse_sigmoid(x):
    x = np.asarray(x, np.float64)
    return np.log(x / (1.0 - x))


def get_expon_lr_func(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-linear LR decay with an optional sine-eased warmup delay."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
            )
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(
            np.log(lr_init) * (1 - t) + np.log(lr_final) * t
        )
        return delay_rate * log_lerp

    return helper


def build_rotation(q):
    """[N, 4] wxyz quaternions -> [N, 3, 3] rotations (normalized first)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - r * z)
    R[:, 0, 2] = 2 * (x * z + r * y)
    R[:, 1, 0] = 2 * (x * y + r * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - r * x)
    R[:, 2, 0] = 2 * (x * z - r * y)
    R[:, 2, 1] = 2 * (y * z + r * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def strip_symmetric(sym):
    """[N, 3, 3] symmetric matrices -> [N, 6] unique upper-triangle
    (xx, xy, xz, yy, yz, zz) — the covariance storage order."""
    sym = np.asarray(sym)
    return np.stack(
        [sym[:, 0, 0], sym[:, 0, 1], sym[:, 0, 2],
         sym[:, 1, 1], sym[:, 1, 2], sym[:, 2, 2]],
        axis=-1,
    )


def build_scaling_rotation(s, q):
    """[N, 3] scales + [N, 4] wxyz quats -> [N, 3, 3] (R @ diag(s));
    L @ L.T is the splat covariance."""
    R = build_rotation(q)
    s = np.asarray(s, np.float64)
    return R * s[:, None, :]


def getWorld2View2(R, t, translate=(0.0, 0.0, 0.0), scale: float = 1.0):
    """4x4 world->camera matrix from COLMAP-convention R (world->cam
    rotation TRANSPOSED, as the reference stores it) and translation t,
    with an optional recentering/rescale of the camera center."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    center = (C2W[:3, 3] + np.asarray(translate)) * scale
    C2W[:3, 3] = center
    return np.linalg.inv(C2W).astype(np.float32)


def getWorld2View(R, t):
    return getWorld2View2(R, t)


def geom_transform_points(points, transf_matrix):
    """[N, 3] points through a 4x4 matrix (row-vector convention,
    homogeneous divide)."""
    points = np.asarray(points, np.float64)
    M = np.asarray(transf_matrix, np.float64)
    ones = np.ones((len(points), 1))
    hom = np.concatenate([points, ones], axis=1) @ M
    return hom[:, :3] / hom[:, 3:4]
