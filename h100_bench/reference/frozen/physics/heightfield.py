"""Frozen copy of pegasus_tpu_torch/physics/heightfield.py at commit 7a69f88, cut to what the benchmark calls.

Environment heightfields: mesh -> regular grid ground model.

Port of ``pegasus_tpu/physics/heightfield.py``.  PEGASUS environments are
plane-aligned (the dominant plane sits at z=0) but carry real relief.  The
environment's collision proxy is a regular heightfield baked once per asset
on the host: a contact query is a bilinear lookup plus a finite-difference
normal, elementwise over any leading axes, so the physics inner loop holds
no data-dependent control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.frozen.device import DEFAULT_DEVICE, resolve_device


class Heightfield(NamedTuple):
    grid: torch.Tensor  # [R, R] height (z) samples
    x0: torch.Tensor  # scalar, grid origin
    y0: torch.Tensor
    inv_dx: torch.Tensor  # scalar, 1 / cell size
    inv_dy: torch.Tensor

    @classmethod
    def flat(cls, resolution: int = 2, extent: float = 10.0,
             device=DEFAULT_DEVICE) -> "Heightfield":
        return _heightfield(
            np.zeros((resolution, resolution), np.float32),
            -extent / 2, -extent / 2,
            (resolution - 1) / extent, (resolution - 1) / extent,
            resolve_device(device),
        )


    def to(self, device) -> "Heightfield":
        return Heightfield(*(t.to(device) for t in self))


def _heightfield(grid, x0, y0, inv_dx, inv_dy, device) -> Heightfield:
    """Scalars round to float32 on the host (numpy), then move."""
    scalar = lambda v: torch.tensor(np.float32(v), dtype=torch.float32, device=device)
    return Heightfield(
        grid=torch.tensor(np.asarray(grid, np.float32), device=device),
        x0=scalar(x0), y0=scalar(y0), inv_dx=scalar(inv_dx), inv_dy=scalar(inv_dy),
    )


def bake_heightfield(vertices, faces, resolution: int = 128,
                     padding: float = 0.05, n_samples: int = 200_000,
                     rng=None, device=DEFAULT_DEVICE) -> Heightfield:
    """Bake a mesh into a max-z heightfield (host-side, once per asset).

    Surface-samples the mesh and bins the max z per cell; empty cells fill
    from the plane (z=0), matching the align2plane invariant.  The numpy
    part is the reference's, line for line; the result lands on ``device``.
    """
    from reference.frozen.io.mesh import TriMesh

    device = resolve_device(device)
    mesh = TriMesh(np.asarray(vertices, np.float64), np.asarray(faces, np.int32))
    rng = rng or np.random.default_rng(0)
    pts = mesh.sample_points(n_samples, rng=rng)
    pts = np.concatenate([pts, mesh.vertices], axis=0)

    lo = pts[:, :2].min(axis=0) - padding
    hi = pts[:, :2].max(axis=0) + padding
    size = np.maximum(hi - lo, 1e-6)
    ix = np.clip(((pts[:, 0] - lo[0]) / size[0] * (resolution - 1)).astype(int),
                 0, resolution - 1)
    iy = np.clip(((pts[:, 1] - lo[1]) / size[1] * (resolution - 1)).astype(int),
                 0, resolution - 1)
    grid = np.zeros((resolution, resolution), np.float32)
    np.maximum.at(grid, (iy, ix), pts[:, 2].astype(np.float32))
    return _heightfield(
        grid, lo[0], lo[1],
        (resolution - 1) / size[0], (resolution - 1) / size[1], device,
    )


def height_at(hf: Heightfield, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear ground height at (x, y); outside the grid -> 0 (the plane).

    ``hf`` is one grid ``[R, R]`` shared by every leading axis of x and y,
    or one grid per scene (``Heightfield.stacked``: grid ``[S, R, R]``,
    scalars ``[S]``) for x and y of shape ``[S, ...]``."""
    r = hf.grid.shape[-1]
    per_scene = hf.grid.dim() == 3
    if per_scene:
        lead = (hf.grid.shape[0],) + (1,) * (x.dim() - 1)
        scene = torch.arange(lead[0], device=x.device).reshape(lead)
        hf = Heightfield(hf.grid, *(v.reshape(lead) for v in hf[1:]))
    fx = (x - hf.x0) * hf.inv_dx
    fy = (y - hf.y0) * hf.inv_dy
    inside = (fx >= 0) & (fx <= r - 1) & (fy >= 0) & (fy <= r - 1)
    # the upper clip bound is the float32 nearest r - 1 - 1e-5, as the
    # reference's weakly typed constant rounds
    hi = float(np.float32(r - 1 - 1e-5))
    fx = torch.clamp(fx, 0.0, hi)
    fy = torch.clamp(fy, 0.0, hi)
    fx0 = torch.floor(fx)
    fy0 = torch.floor(fy)
    tx = fx - fx0
    ty = fy - fy0
    x0 = fx0.long()
    y0 = fy0.long()
    g = hf.grid
    at = (lambda yy, xx: g[scene, yy, xx]) if per_scene else (lambda yy, xx: g[yy, xx])
    h = (
        at(y0, x0) * (1 - tx) * (1 - ty)
        + at(y0, x0 + 1) * tx * (1 - ty)
        + at(y0 + 1, x0) * (1 - tx) * ty
        + at(y0 + 1, x0 + 1) * tx * ty
    )
    return torch.where(inside, h, torch.zeros_like(h))


def normal_at(hf: Heightfield, x: torch.Tensor, y: torch.Tensor,
              eps: float = 1e-2) -> torch.Tensor:
    """[..., 3] unit ground normal via central differences."""
    hx = (height_at(hf, x + eps, y) - height_at(hf, x - eps, y)) / (2 * eps)
    hy = (height_at(hf, x, y + eps) - height_at(hf, x, y - eps)) / (2 * eps)
    n = torch.stack([-hx, -hy, torch.ones_like(hx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
