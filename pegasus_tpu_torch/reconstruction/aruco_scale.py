"""Copied verbatim from ``pegasus_tpu/reconstruction/aruco_scale.py``; only the import lines differ.

Metric scale recovery from ArUco markers.

Reimplementation of the aruco-estimator submodule's pipeline (SURVEY 2.5):
detect the marker in every registered image, cast the 4 corner rays
through the COLMAP camera poses, intersect each corner's ray bundle by
least squares (the P3 closest-point problem, cf. aruco_estimator/opt.py),
and return scale = true_marker_size / estimated_side_length.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from pegasus_tpu_torch.io import colmap as cio
from pegasus_tpu_torch.utils.pose import qvec2rotmat


def _ls_ray_intersection(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares point minimizing distance to all rays (o_i, d_i)."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for o, d in zip(origins, dirs):
        d = d / np.linalg.norm(d)
        P = np.eye(3) - np.outer(d, d)
        A += P
        b += P @ o
    return np.linalg.solve(A, b)


def detect_aruco_corners(image_path, aruco_dict: str = "DICT_4X4_50"):
    """{marker_id: [4, 2] pixel corners} for one image (cv2.aruco)."""
    import cv2

    img = cv2.imread(str(image_path))
    if img is None:
        return {}
    dictionary = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, aruco_dict))
    detector = cv2.aruco.ArucoDetector(dictionary, cv2.aruco.DetectorParameters())
    corners, ids, _ = detector.detectMarkers(img)
    out = {}
    if ids is not None:
        for c, i in zip(corners, ids.ravel()):
            out[int(i)] = c.reshape(4, 2)
    return out


def estimate_aruco_scale(
    sparse_dir,
    image_dir,
    aruco_size: float,
    aruco_dict: str = "DICT_4X4_50",
    min_views: int = 3,
) -> float:
    sparse_dir = Path(sparse_dir)
    image_dir = Path(image_dir)
    cams = cio.read_cameras_binary(sparse_dir / "cameras.bin")
    images = cio.read_images_binary(sparse_dir / "images.bin")

    # corner index -> list of (origin, direction) rays in world frame
    rays: Dict[int, List] = {k: [] for k in range(4)}
    marker_id = None
    for im in images.values():
        det = detect_aruco_corners(image_dir / im.name, aruco_dict)
        if not det:
            continue
        if marker_id is None:
            marker_id = sorted(det.keys())[0]
        if marker_id not in det:
            continue
        intr = cams[im.camera_id]
        fx, fy, cx, cy = cio.colmap_intrinsics(intr)
        R = qvec2rotmat(im.qvec)
        t = np.asarray(im.tvec)
        origin = -R.T @ t
        for k in range(4):
            u, v = det[marker_id][k]
            d_cam = np.array([(u - cx) / fx, (v - cy) / fy, 1.0])
            rays[k].append((origin, R.T @ d_cam))

    n_views = min(len(rays[k]) for k in range(4))
    if n_views < min_views:
        raise RuntimeError(
            f"ArUco marker seen in only {n_views} registered images "
            f"(need >= {min_views})"
        )

    corners3d = []
    for k in range(4):
        origins = np.stack([o for o, _ in rays[k]])
        dirs = np.stack([d for _, d in rays[k]])
        corners3d.append(_ls_ray_intersection(origins, dirs))
    corners3d = np.stack(corners3d)

    sides = [
        np.linalg.norm(corners3d[i] - corners3d[(i + 1) % 4]) for i in range(4)
    ]
    est_side = float(np.mean(sides))
    if est_side <= 0:
        raise RuntimeError("degenerate ArUco reconstruction")
    return aruco_size / est_side
