"""Frozen copy of pegasus_tpu_torch/utils/pose.py at commit 7a69f88, cut to what the benchmark calls.

Copied verbatim from ``pegasus_tpu/utils/pose.py``; only the import lines differ.

SE(3) pose helpers and pose interpolation.

Numpy-side (host) helpers mirror the reference's utilities
(reference: src/utility/pose_interpolation.py:20-107) so that camera
trajectories interpolate bit-compatibly; JAX variants are provided for
on-device use.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# host-side (numpy) — used for camera trajectory generation, BOP math
# ---------------------------------------------------------------------------


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion -> rotation matrix
    (reference: src/utility/graphic_utils.py:13-23)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """rotation matrix -> COLMAP wxyz quaternion
    (reference: src/utility/graphic_utils.py:26-37)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def pose_matrix_to_quat(pose: np.ndarray) -> np.ndarray:
    """4x4 -> (qx, qy, qz, qw, x, y, z), scipy xyzw layout
    (reference: src/utility/pose_interpolation.py:20-27)."""
    assert pose.shape == (4, 4)
    q_wxyz = rotmat2qvec(pose[:3, :3])
    q_xyzw = np.roll(q_wxyz, -1)
    return np.hstack((q_xyzw, pose[:3, 3]))


def pose_quat_to_matrix(pose7: np.ndarray) -> np.ndarray:
    """(qx,qy,qz,qw,x,y,z) -> 4x4
    (reference: src/utility/pose_interpolation.py:30-40)."""
    assert pose7.size == 7
    q_wxyz = np.roll(pose7[:4], 1)
    q_wxyz = q_wxyz / np.linalg.norm(q_wxyz)
    p = np.eye(4, dtype=np.float64)
    p[:3, :3] = qvec2rotmat(q_wxyz)
    p[:3, 3] = pose7[4:]
    return p


def quaternion_slerp(q1: np.ndarray, q2: np.ndarray, alpha: float) -> np.ndarray:
    """SLERP with the reference's lerp fallback
    (reference: src/utility/pose_interpolation.py:58-84)."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    dot = q1.dot(q2)
    if dot < 0:
        q1 = -q1
        dot = -dot
    if dot > 0.9995:
        res = q1 + alpha * (q2 - q1)
        return res / np.linalg.norm(res)
    theta_0 = np.arccos(np.clip(dot, -1.0, 1.0))
    theta = theta_0 * alpha
    sin_theta = np.sin(theta)
    sin_theta_0 = np.sin(theta_0)
    s1 = np.cos(theta) - dot * sin_theta / sin_theta_0
    s2 = sin_theta / sin_theta_0
    return s1 * q1 + s2 * q2


def interpolate_pose(t: float, t1: float, pose1: np.ndarray, t2: float, pose2: np.ndarray) -> np.ndarray:
    """lerp position + SLERP rotation between two 4x4 poses
    (reference: src/utility/pose_interpolation.py:87-107)."""
    if pose1.shape == (4, 4):
        pose1 = pose_matrix_to_quat(pose1)
    if pose2.shape == (4, 4):
        pose2 = pose_matrix_to_quat(pose2)
    r = (float(t) - float(t1)) / (float(t2) - float(t1))
    pos = pose1[4:] + r * (pose2[4:] - pose1[4:])
    rot = quaternion_slerp(pose1[:4], pose2[:4], r)
    return pose_quat_to_matrix(np.hstack((rot, pos)))


# ---------------------------------------------------------------------------
# focal length <-> field of view (Inria utils.graphics_utils contract,
# consumed at reference: src/gs/pegasus_setup.py:119-122,
# src/tools/pegasus_bop.py:348-366)
# ---------------------------------------------------------------------------


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


# ---------------------------------------------------------------------------
# graphics helpers mirrored from the reference's graphic_utils
# (reference: src/utility/graphic_utils.py:7-112)
# ---------------------------------------------------------------------------


