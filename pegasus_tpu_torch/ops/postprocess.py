"""Screen-space post-processing: depth normals + SSAO (torch).

Port of ``pegasus_tpu/ops/postprocess.py``, the reference's offline SSAO
prototype (reference: src/gs/ao_test.py: normals from depth via Sobel
:37-67, SSAO from depth+normals :126-152, applied to RGB :184-188).  Plain
tensor code on the depth map's device; not wired into the default pipeline
(the reference never wired it either).  The 3x3 Sobel is written as shifted
slices of the zero-padded map, the same sums as the JAX package's "SAME"
convolution: the package runs no convolution, because cuDNN's float32
convolutions default to TF32.  The JAX package's ``lax.scan`` over samples is
a Python loop here.
"""

from __future__ import annotations

import math

import torch


def _sobel(depth: torch.Tensor):
    """(dz/dx, dz/dy) of an [H, W] depth map: 3x3 Sobel filters / 8 over
    the zero-padded map (cross-correlation, as a convolution layer does)."""
    h, w = depth.shape
    p = torch.nn.functional.pad(depth, (1, 1, 1, 1))
    at = lambda dy, dx: p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    gx = ((at(-1, 1) - at(-1, -1)) + 2.0 * (at(0, 1) - at(0, -1)) + (at(1, 1) - at(1, -1))) / 8.0
    gy = ((at(1, -1) - at(-1, -1)) + 2.0 * (at(1, 0) - at(-1, 0)) + (at(1, 1) - at(-1, 1))) / 8.0
    return gx, gy


def normals_from_depth(depth: torch.Tensor, strength: float = 1.0) -> torch.Tensor:
    """[H, W, 3] unit normal map from camera-space depth (ao_test.py:37-67)."""
    gx, gy = _sobel(depth)
    n = torch.stack([-gx * strength, -gy * strength, torch.ones_like(depth)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def ssao(
    depth: torch.Tensor,
    normals: torch.Tensor | None = None,
    radius_px: int = 8,
    n_samples: int = 16,
    strength: float = 1.0,
    key=None,
) -> torch.Tensor:
    """[H, W] ambient-occlusion factor in [0, 1] (1 = unoccluded).

    Horizon-style screen-space AO: sample depth at fixed offsets around
    each pixel; occlusion accumulates where neighbours are closer to the
    camera than the centre by more than a normal-dependent bias
    (ao_test.py:126-152).  The offsets are fixed, so ``key`` is read by
    nothing, as in the JAX package."""
    if normals is None:
        normals = normals_from_depth(depth)
    angles = torch.linspace(0, 2 * math.pi, n_samples + 1, dtype=torch.float32)[:-1]
    radii = (torch.arange(n_samples) % 4 + 1) / 4.0 * radius_px
    dx = torch.round(torch.cos(angles) * radii).to(torch.int64).tolist()
    dy = torch.round(torch.sin(angles) * radii).to(torch.int64).tolist()
    bias = 0.01 + 0.02 * (1.0 - normals[..., 2])
    occ = torch.zeros_like(depth)
    for i in range(n_samples):
        shifted = torch.roll(torch.roll(depth, dy[i], dims=0), dx[i], dims=1)
        diff = depth - shifted  # > 0 where the neighbour is closer
        occ = occ + torch.clamp(diff - bias, 0.0, 0.1) / 0.1
    ao = 1.0 - torch.clamp(strength * occ / n_samples, 0.0, 1.0)
    return torch.where(depth > 0, ao, torch.ones_like(ao))


def apply_ssao(rgb: torch.Tensor, depth: torch.Tensor, **kwargs) -> torch.Tensor:
    """Darken RGB by the AO factor (ao_test.py:184-188)."""
    ao = ssao(depth, **kwargs)
    return torch.clamp(rgb * ao[..., None], 0.0, 1.0)
