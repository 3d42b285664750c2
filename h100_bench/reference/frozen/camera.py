"""Frozen copy of pegasus_tpu_torch/camera.py at commit 7a69f88, cut to what the benchmark calls.

Pinhole camera model and COLMAP-convention constructors.

Port of ``pegasus_tpu/camera.py``.  Conventions:

* COLMAP extrinsics: x_cam = R_w2c @ x_world + t_w2c, +z forward.
* The Inria Camera is constructed with R = R_w2c^T (camera-to-world
  rotation) and T = t_w2c; ``from_inria`` accepts that layout.
* Pixel mapping follows the CUDA rasterizer's ndc2Pix:
  pix = ((ndc + 1) * size - 1) / 2, i.e. principal point (size-1)/2;
  ``K(bop_convention=True)`` reports the BOP writer's cx = W/2.

The extrinsics are float32 tensors on ``device`` (the card by default); the field of view is kept
as float32 host scalars, so per-frame projection needs no device round trip
for the intrinsics.  ``CameraBatch`` stacks same-resolution cameras into
tensors with a leading camera axis (the reference's ``_stack_cams``), which
``project_gaussians`` projects in one pass.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from reference.frozen.device import DEFAULT_DEVICE, resolve_device
from reference.frozen.utils.pose import qvec2rotmat


@dataclass(frozen=True)
class Camera:
    """World-to-camera extrinsics + pinhole intrinsics."""

    R_w2c: torch.Tensor  # [3, 3] float32
    t_w2c: torch.Tensor  # [3] float32
    fovx: float  # radians (a float32 value)
    fovy: float
    width: int = 640
    height: int = 480
    znear: float = 0.01  # clip planes, as the reference carries them; projection
    zfar: float = 100.0  # reads neither (its near cull is at 0.2)

    @classmethod
    def create(cls, R_w2c, t_w2c, fovx, fovy, width, height, device=DEFAULT_DEVICE) -> "Camera":
        device = resolve_device(device)
        return cls(
            R_w2c=torch.tensor(np.asarray(R_w2c, np.float32), device=device),
            t_w2c=torch.tensor(np.asarray(t_w2c, np.float32), device=device),
            fovx=float(np.float32(fovx)),
            fovy=float(np.float32(fovy)),
            width=int(width),
            height=int(height),
        )

    @classmethod
    def from_colmap(cls, qvec, tvec, fovx, fovy, width, height, device=DEFAULT_DEVICE) -> "Camera":
        return cls.create(qvec2rotmat(np.asarray(qvec)), tvec, fovx, fovy, width, height, device)

    @classmethod
    def from_inria(cls, R, T, FoVx, FoVy, width, height, device=DEFAULT_DEVICE) -> "Camera":
        """Inria Camera ctor layout: R is camera-to-world, T is world-to-camera."""
        R = np.asarray(R, np.float32)
        return cls.create(R.T, T, FoVx, FoVy, width, height, device)


    def replace(self, **updates) -> "Camera":
        return dataclasses.replace(self, **updates)

    @property
    def device(self) -> torch.device:
        return self.R_w2c.device

    @property
    def camera_center(self) -> torch.Tensor:
        return -self.R_w2c.T @ self.t_w2c

    def tan_half_fov(self) -> tuple[float, float]:
        """float32-rounded tan(fov/2), as the reference computes it."""
        half = np.float32(0.5)
        return (
            float(np.tan(half * np.float32(self.fovx))),
            float(np.tan(half * np.float32(self.fovy))),
        )

    def focal_px(self) -> tuple[float, float]:
        tx, ty = self.tan_half_fov()
        return (
            float(np.float32(self.width) / (np.float32(2.0) * np.float32(tx))),
            float(np.float32(self.height) / (np.float32(2.0) * np.float32(ty))),
        )

    def K(self, bop_convention: bool = False) -> torch.Tensor:
        """3x3 intrinsics; bop_convention=True uses cx = W/2, else (W-1)/2."""
        fx, fy = self.focal_px()
        if bop_convention:
            cx, cy = self.width / 2.0, self.height / 2.0
        else:
            cx, cy = (self.width - 1) / 2.0, (self.height - 1) / 2.0
        return torch.tensor(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=self.device,
        )


    def T_w2c(self) -> torch.Tensor:
        """4x4 world-to-camera matrix."""
        T = torch.eye(4, dtype=torch.float32, device=self.device)
        T[:3, :3] = self.R_w2c
        T[:3, 3] = self.t_w2c
        return T


@dataclass(frozen=True)
class CameraBatch:
    """C same-resolution cameras as tensors with a leading camera axis.

    Every per-camera value holds the float32 bits that the single
    ``Camera`` gives the projection: ``camera_center`` is each camera's own
    ``Camera.camera_center``, and ``tan_x`` ... ``focal_y`` are the host
    floats of ``tan_half_fov`` and ``focal_px``.  Built once per camera
    path (``stack``; one host-to-device copy) and sliced per chunk (views)."""

    R_w2c: torch.Tensor  # [C, 3, 3] float32
    t_w2c: torch.Tensor  # [C, 3]
    camera_center: torch.Tensor  # [C, 3]
    tan_x: torch.Tensor  # [C] float32 tan(fovx / 2)
    tan_y: torch.Tensor
    focal_x: torch.Tensor  # [C] float32 pixels
    focal_y: torch.Tensor
    width: int
    height: int
    # the cameras themselves, for a renderer that takes one Camera at a time
    cameras: tuple = dataclasses.field(default=(), repr=False, compare=False)

    @classmethod
    def stack(cls, cams) -> "CameraBatch":
        if not cams:
            raise ValueError("no cameras")
        w, h = cams[0].width, cams[0].height
        if any(c.width != w or c.height != h for c in cams):
            raise ValueError("CameraBatch requires uniform resolution")
        scalars = torch.tensor(
            [c.tan_half_fov() + c.focal_px() for c in cams], dtype=torch.float32,
            device=cams[0].device,
        )
        tan_x, tan_y, focal_x, focal_y = scalars.T
        return cls(
            R_w2c=torch.stack([c.R_w2c for c in cams]),
            t_w2c=torch.stack([c.t_w2c for c in cams]),
            camera_center=torch.stack([c.camera_center for c in cams]),
            tan_x=tan_x, tan_y=tan_y, focal_x=focal_x, focal_y=focal_y,
            width=w, height=h, cameras=tuple(cams),
        )

    def __len__(self) -> int:
        return self.R_w2c.shape[0]

    def __getitem__(self, index: slice) -> "CameraBatch":
        """The cameras ``index`` (a slice) as a batch of views."""
        return CameraBatch(
            *(getattr(self, f)[index] for f in ("R_w2c", "t_w2c", "camera_center",
                                                 "tan_x", "tan_y", "focal_x", "focal_y")),
            width=self.width, height=self.height, cameras=self.cameras[index],
        )

    @property
    def device(self) -> torch.device:
        return self.R_w2c.device


