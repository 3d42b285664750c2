"""Frozen copy of pegasus_tpu_torch/ops/projection.py at commit 7a69f88, cut to what the benchmark calls.

3D Gaussian -> 2D screen-space projection (EWA splatting).

Port of ``pegasus_tpu/ops/projection.py``, the geometric front end of every
rasterizer: world->camera transform, near-cull at 0.2, the 1.3*tan(fov/2)
clamp, perspective Jacobian, cov2D + 0.3 px low-pass, conic inversion,
radius ceil(3*sqrt(lambda1)), ndc2pix mean and SH -> RGB view-dependent
colour.  Plain elementwise torch on [N] columns, or on [C, N] columns for a
``CameraBatch`` of C cameras (a chunk of frames), where the cloud may carry
a leading pose axis too (``scene.composition.pose_scene`` of C poses).  The
per-camera terms are then [C, 1] columns holding the same float32 values
that one camera's Python floats and 0-d tensors give, and every operation
is elementwise, so each frame of a chunk gets the bits of its own
single-camera projection.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.frozen.camera import Camera, CameraBatch
from reference.frozen.gs.cloud import GaussianCloud
from reference.frozen.utils import sh as shlib


class ProjectedGaussians(NamedTuple):
    """Screen-space splats as flat columns (one entry per input splat):
    [N], or [C, N] for a chunk of C frames (every field the same shape)."""

    mean_x: torch.Tensor  # [N] pixel coords
    mean_y: torch.Tensor
    conic_a: torch.Tensor  # inverse cov2D upper triangle
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    color_r: torch.Tensor  # view-dependent RGB (>= 0)
    color_g: torch.Tensor
    color_b: torch.Tensor
    opacity: torch.Tensor  # post-sigmoid alpha multiplier
    depth: torch.Tensor  # camera-space z
    radius: torch.Tensor  # pixel radius (3 sigma); 0 for invalid
    object_id: torch.Tensor  # int32
    valid: torch.Tensor  # bool


def _camera_terms(cam: Camera | CameraBatch):
    """(rotation entries r[0..8], t[0..2], camera centre c[0..2], tan_x,
    tan_y, f_x, f_y, clamp limits 1.3 tan): Python floats and 0-d tensors
    for one camera, [C, 1] float32 columns for a batch.  A Python float
    enters a float32 kernel rounded to float32, so the batch rounds the
    float64 product 1.3 tan the same way."""
    if isinstance(cam, Camera):
        tanx, tany = cam.tan_half_fov()
        return (cam.R_w2c.reshape(9).unbind(0), cam.t_w2c.unbind(0), cam.camera_center.unbind(0),
                tanx, tany, *cam.focal_px(), 1.3 * tanx, 1.3 * tany)
    col = lambda v: v[:, None]  # noqa: E731
    lim = lambda tan: col((tan.double() * 1.3).float())  # noqa: E731
    return (tuple(map(col, cam.R_w2c.reshape(-1, 9).unbind(1))), tuple(map(col, cam.t_w2c.unbind(1))),
            tuple(map(col, cam.camera_center.unbind(1))), col(cam.tan_x), col(cam.tan_y),
            col(cam.focal_x), col(cam.focal_y), lim(cam.tan_x), lim(cam.tan_y))


def _like(column: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A per-splat [N] column broadcast to ``ref``'s [C, N] (a view)."""
    return column if column.shape == ref.shape else column.expand_as(ref)


def project_gaussians(
    cloud: GaussianCloud,
    cam: Camera | CameraBatch,
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    near: float = 0.2,
) -> ProjectedGaussians:
    x, y, z = cloud.xyz.unbind(-1)
    r, t, c, tanx, tany, fx, fy, limx, limy = _camera_terms(cam)

    tx_c = r[0] * x + r[1] * y + r[2] * z + t[0]
    ty_c = r[3] * x + r[4] * y + r[5] * z + t[1]
    tz_c = r[6] * x + r[7] * y + r[8] * z + t[2]
    in_front = tz_c > near

    tz_safe = torch.where(in_front, tz_c, torch.ones_like(tz_c))
    txtz = torch.clamp(tx_c / tz_safe, -limx, limx)
    tytz = torch.clamp(ty_c / tz_safe, -limy, limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    # world-space covariance Sigma = Rq S^2 Rq^T, per component
    qw, qx, qy, qz = cloud.get_rotation().unbind(-1)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s = scaling_modifier * cloud.get_scaling()
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    sg00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    sg01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    sg02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    sg11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    sg12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    sg22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2

    # rows u, v of J @ W (J = perspective Jacobian, W = R_w2c)
    z_inv = 1.0 / tz_safe
    z_inv2 = z_inv * z_inv
    j00 = fx * z_inv
    j02 = -fx * tx * z_inv2
    j11 = fy * z_inv
    j12 = -fy * ty * z_inv2
    u0 = j00 * r[0] + j02 * r[6]
    u1 = j00 * r[1] + j02 * r[7]
    u2 = j00 * r[2] + j02 * r[8]
    v0 = j11 * r[3] + j12 * r[6]
    v1 = j11 * r[4] + j12 * r[7]
    v2 = j11 * r[5] + j12 * r[8]

    # cov2D = [u; v] Sigma [u; v]^T + 0.3 I
    su0 = sg00 * u0 + sg01 * u1 + sg02 * u2
    su1 = sg01 * u0 + sg11 * u1 + sg12 * u2
    su2 = sg02 * u0 + sg12 * u1 + sg22 * u2
    sv0 = sg00 * v0 + sg01 * v1 + sg02 * v2
    sv1 = sg01 * v0 + sg11 * v1 + sg12 * v2
    sv2 = sg02 * v0 + sg12 * v1 + sg22 * v2
    cov_a = u0 * su0 + u1 * su1 + u2 * su2 + 0.3
    cov_b = u0 * sv0 + u1 * sv1 + u2 * sv2
    cov_c = v0 * sv0 + v1 * sv1 + v2 * sv2 + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    nondegenerate = det > 0.0
    det_safe = torch.where(nondegenerate, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic_a = cov_c * inv_det
    conic_b = -cov_b * inv_det
    conic_c = cov_a * inv_det

    # 3-sigma radius from the larger eigenvalue (CUDA: ceil(3 sqrt(lambda1)))
    mid = 0.5 * (cov_a + cov_c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    # pixel-space mean; ndc2Pix convention ((ndc+1)*S - 1) / 2
    mean_x = ((tx_c / (tanx * tz_safe) + 1.0) * cam.width - 1.0) * 0.5
    mean_y = ((ty_c / (tany * tz_safe) + 1.0) * cam.height - 1.0) * 0.5

    # view-dependent color: direction from the camera center to the splat
    if sh_degree is None:
        sh_degree = cloud.sh_degree
    dx, dy, dz = x - c[0], y - c[1], z - c[2]
    inv_n = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    dirs = torch.stack([dx * inv_n, dy * inv_n, dz * inv_n], dim=-1)
    feats = cloud.get_features()[..., : (sh_degree + 1) ** 2, :]
    color = torch.clamp(shlib.eval_sh(sh_degree, feats, dirs) + 0.5, min=0.0)

    valid = cloud.alive & in_front & nondegenerate

    return ProjectedGaussians(
        mean_x=mean_x,
        mean_y=mean_y,
        conic_a=conic_a,
        conic_b=conic_b,
        conic_c=conic_c,
        color_r=color[..., 0],
        color_g=color[..., 1],
        color_b=color[..., 2],
        opacity=_like(cloud.get_opacity()[:, 0], tz_c),
        depth=tz_c,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        object_id=_like(cloud.object_id, tz_c),
        valid=valid,
    )


