"""Frozen copy of pegasus_tpu_torch/io/colmap.py at commit 7a69f88, cut to what the benchmark calls.

Copied verbatim from ``pegasus_tpu/io/colmap.py``; only the import lines differ.

COLMAP binary model I/O (cameras.bin / images.bin / points3D.bin).

Standalone reimplementation of the subset of the colmap-wrapper submodule
the reference uses (reference: pegasus.py:18,97-98 reads images.bin and
cameras.bin of each environment; write_* used by pegasus_setup.py:19-21).
Format follows the public COLMAP binary spec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific; PINHOLE: fx fy cx cy


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # wxyz, world-to-camera rotation
    tvec: np.ndarray  # world-to-camera translation
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * n_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def write_cameras_binary(cams: Dict[int, ColmapCamera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model_id = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            image_id = _read(f, "i")[0]
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            (camera_id,) = _read(f, "i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_points,) = _read(f, "Q")
            data = np.frombuffer(f.read(24 * num_points), dtype=np.float64)
            data = data.reshape(num_points, 3)
            xys = data[:, :2].copy()
            point3D_ids = data[:, 2].view(np.int64)[:].copy()
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode(), xys, point3D_ids
            )
    return images


def write_images_binary(images: Dict[int, ColmapImage], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            if n:
                data = np.empty((n, 3), np.float64)
                data[:, :2] = im.xys
                data[:, 2] = im.point3D_ids.astype(np.int64).view(np.float64)
                f.write(data.tobytes())


def write_points3d_binary(points: Dict[int, ColmapPoint3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<ddd", *p.xyz))
            f.write(struct.pack("<BBB", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            n = len(p.image_ids)
            f.write(struct.pack("<Q", n))
            track = np.empty((n, 2), np.int32)
            track[:, 0] = p.image_ids
            track[:, 1] = p.point2D_idxs
            f.write(track.tobytes())


def colmap_intrinsics(cam: ColmapCamera) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy) for the pinhole-ish models PEGASUS uses."""
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
        f, cx, cy = cam.params[:3]
        return float(f), float(f), float(cx), float(cy)
    if cam.model in ("PINHOLE", "OPENCV"):
        fx, fy, cx, cy = cam.params[:4]
        return float(fx), float(fy), float(cx), float(cy)
    raise ValueError(f"unsupported camera model {cam.model}")


# ---------------------------------------------------------------------------
# text-format model I/O (the reference also imports the text writers,
# src/gs/pegasus_setup.py:19-21)
# ---------------------------------------------------------------------------


