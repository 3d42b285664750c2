"""Frozen copy of pegasus_tpu_torch/utils/quaternion.py at commit 7a69f88, cut to what the benchmark calls.

Quaternion / rotation utilities on torch tensors, batched over leading dims.

Port of ``pegasus_tpu/utils/quaternion.py``.  Layouts are named in the
function names: ``wxyz`` (COLMAP, Inria per-splat rotations) is canonical,
``xyzw`` is the PyBullet / trajectory-JSON layout.
"""

from __future__ import annotations

import torch


def xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) -> 3x3 rotation matrix(es); normalizes first."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix(es) -> wxyz quaternion(s) with w >= 0.

    Shepperd-style: builds the four candidates and keeps the one with the
    largest 4*q_k^2, exactly as the reference does."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4 cand, 4]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., 0:1] < 0, -q, q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b for wxyz quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


