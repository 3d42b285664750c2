"""Golden-model compositor: exact alpha-compositing semantics in plain torch.

Port of ``pegasus_tpu/ops/rasterize_ref.py``, the oracle the tile
compositor is held against.  One pass over depth-sorted splats emits every
modality: RGB, expected depth, accumulated alpha, per-object visible
weights (with and without the environment) and per-object amodal
accumulations.  Front-to-back 'over' is a scan over depth-ordered splat
chunks with an exclusive cumulative product of (1 - alpha) inside each
chunk.  Cost is O(pixels x splats): clarity over speed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.ops.projection import (
    ProjectedGaussians,
    project_gaussians,
    splat_alpha_at_pixels,
)


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor  # [H, W, 3] composited color incl. background
    depth: torch.Tensor  # [H, W] expected camera-space depth (sum w_i * z_i)
    alpha: torch.Tensor  # [H, W] accumulated opacity of the full scene
    seg_weights: torch.Tensor  # [H, W, K] per-object visible weight, full scene
    vis_weights: torch.Tensor  # [H, W, K] same but environment splats removed
    amodal: torch.Tensor  # [H, W, K] per-object standalone accumulated alpha


def rasterize_projected(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    background,
    max_objects: int = 8,
    chunk: int = 256,
) -> RenderOutputs:
    """Composite projected splats over all pixels.

    max_objects: bound on object ids (env id 0 is channel 0; ids >=
    max_objects are clipped into the last channel, as in the reference).
    """
    dev = proj.mean_x.device
    n = proj.mean_x.shape[0]
    k = max_objects

    # depth-ascending order among valid splats (invalid pushed to the back)
    sort_key = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(sort_key, stable=True)
    proj = ProjectedGaussians(*(f[order] for f in proj))

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    p = px.shape[0]

    onehot = torch.nn.functional.one_hot(
        torch.clamp(proj.object_id.long(), 0, k - 1), k
    ).to(torch.float32)  # [N, K]
    is_env = proj.object_id == 0
    rgb_cols = torch.stack([proj.color_r, proj.color_g, proj.color_b], dim=1)

    t_full = torch.ones(p, device=dev)
    t_noenv = torch.ones(p, device=dev)
    rgb = torch.zeros(p, 3, device=dev)
    depth = torch.zeros(p, device=dev)
    seg_full = torch.zeros(p, k, device=dev)
    seg_noenv = torch.zeros(p, k, device=dev)
    amodal_log = torch.zeros(p, k, device=dev)

    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        cproj = ProjectedGaussians(*(f[sl] for f in proj))
        c_onehot = onehot[sl]

        alphas = splat_alpha_at_pixels(cproj, px, py)  # [P, C]

        # full-scene weights: w_i = alpha_i * prod_{j<i}(1-alpha_j)
        log1m = torch.log1p(-alphas)  # alphas <= 0.99 -> safe
        excl = torch.exp(torch.cumsum(log1m, dim=1) - log1m)
        w_full = alphas * excl * t_full[:, None]
        rgb = rgb + w_full @ rgb_cols[sl]
        depth = depth + w_full @ cproj.depth
        seg_full = seg_full + w_full @ c_onehot
        t_full = t_full * torch.exp(torch.sum(log1m, dim=1))

        # environment-free compositing (objects are never occluded by the
        # env in mask renders, the reference's quirk)
        alphas_ne = torch.where(is_env[sl][None, :], torch.zeros_like(alphas), alphas)
        log1m_ne = torch.log1p(-alphas_ne)
        excl_ne = torch.exp(torch.cumsum(log1m_ne, dim=1) - log1m_ne)
        w_ne = alphas_ne * excl_ne * t_noenv[:, None]
        seg_noenv = seg_noenv + w_ne @ c_onehot
        t_noenv = t_noenv * torch.exp(torch.sum(log1m_ne, dim=1))

        # amodal: per object, log prod (1 - alpha) over ITS OWN splats only
        amodal_log = amodal_log + log1m @ c_onehot

    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    rgb = rgb + t_full[:, None] * bg[None, :]
    return RenderOutputs(
        rgb=rgb.reshape(height, width, 3),
        depth=depth.reshape(height, width),
        alpha=(1.0 - t_full).reshape(height, width),
        seg_weights=seg_full.reshape(height, width, k),
        vis_weights=seg_noenv.reshape(height, width, k),
        amodal=(1.0 - torch.exp(amodal_log)).reshape(height, width, k),
    )


def rasterize_reference(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
    chunk: int = 256,
) -> RenderOutputs:
    """Project + composite a full scene cloud for one camera."""
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    return rasterize_projected(
        proj, cam.width, cam.height, background, max_objects=max_objects, chunk=chunk
    )
