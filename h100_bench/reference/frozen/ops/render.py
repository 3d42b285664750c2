"""Frozen copy of pegasus_tpu_torch/ops/render.py at commit 7a69f88, without the render wrappers and the RLE readback; cut to what the benchmark calls.

Modality API: one fused render -> every PEGASUS data point.

Port of ``pegasus_tpu/ops/render.py``.  A single compositor pass yields rgb,
depth, per-object visible masks (environment excluded from occlusion, the
reference's quirk), amodal silhouettes and the semantic image.  Masks are
exact functions of per-object compositing weights; the 0.9 threshold
mirrors the reference's 0.1 colour-distance acceptance.

``encode_frame`` and ``pack_frame_bytes`` run on the device, so one uint8
tensor per frame crosses to the host; ``unpack_frame_bytes`` and
``_unpack_planes`` are the reference's numpy host decode, copied.  The RLE
compact readback (``split_frame_planes``, ``rle_pack_chunk`` on the device,
``rle_unpack_chunk`` on the host) writes the reference's bytes.

A chunk of C frames (``render_chunk``, the reference's ``lax.map`` chunk
program) carries a leading [C] axis through ``decode_modalities``,
``encode_frame``, ``pack_frame_bytes`` and ``split_frame_planes``, which
work on any leading axes, so a chunk crosses to the host as one tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.frozen.camera import CameraBatch
from reference.frozen.gs.cloud import GaussianCloud
from reference.frozen.ops.rasterize_cuda import rasterize_chunk
from reference.frozen.ops.rasterize_ref import RenderOutputs

MASK_THRESHOLD = 0.9


class FrameDataPoints(NamedTuple):
    """One frame's data points; a chunk's carry a leading [C] axis."""

    rgb: torch.Tensor  # [H, W, 3] float in [0,1]
    depth: torch.Tensor  # [H, W] float meters
    alpha: torch.Tensor  # [H, W]
    mask_visib: torch.Tensor  # [H, W, K] bool (channel k-1 = object id k)
    mask_amodal: torch.Tensor  # [H, W, K] bool
    seg_image: torch.Tensor  # [H, W, 3] float
    vis_weights: torch.Tensor  # [H, W, K] raw weights


def decode_modalities(
    out: RenderOutputs,
    semantic_colors: torch.Tensor,  # [K, 3] palette for object ids 1..K
    mask_threshold: float = MASK_THRESHOLD,
) -> FrameDataPoints:
    k = semantic_colors.shape[0]
    # channel 0 of seg/vis weights is the environment; objects are 1..K
    vis = out.vis_weights[..., 1 : k + 1]
    amodal = out.amodal[..., 1 : k + 1]
    # the seg image reaches no written file (the host rebuilds it from the
    # visib bits), so its contraction may round differently in a chunk
    seg_image = torch.einsum("...k,kc->...c", vis, semantic_colors.to(torch.float32))
    return FrameDataPoints(
        rgb=torch.clamp(out.rgb, 0.0, 1.0),
        depth=out.depth,
        alpha=out.alpha,
        mask_visib=vis >= mask_threshold,
        mask_amodal=amodal >= mask_threshold,
        seg_image=torch.clamp(seg_image, 0.0, 1.0),
        vis_weights=vis,
    )


def render_chunk(
    scene: GaussianCloud,
    cams: CameraBatch,
    semantic_colors: torch.Tensor,
    background=(0.0, 0.0, 0.0),
    max_objects: int | None = None,
    rasterize_fn=None,
    **kwargs,
) -> FrameDataPoints:
    """``render_frame`` of C cameras: data points with a leading [C] axis.
    ``scene`` is one posed scene (a static chunk) or a scene posed C ways
    (a dynamic chunk).  With ``rasterize_fn`` None the chunk renders in one
    pass (``rasterize_chunk``: one binning host read and one forward
    launch); a given ``rasterize_fn`` renders each frame of the chunk in
    turn, as the reference's ``lax.map`` does, and the frames are stacked."""
    if max_objects is None:
        max_objects = semantic_colors.shape[0] + 1
    if rasterize_fn is None:
        out = rasterize_chunk(scene, cams, background=background, max_objects=max_objects)
    else:
        posed = scene.xyz.dim() == 3
        frames = [
            rasterize_fn(scene.pose_frame(j) if posed else scene, cam, background=background,
                         max_objects=max_objects, **kwargs)
            for j, cam in enumerate(cams.cameras)
        ]
        out = RenderOutputs(*(torch.stack(field) for field in zip(*frames)))
    return decode_modalities(out, semantic_colors)


# ---------------------------------------------------------------------------
# Reference-signature compatibility wrappers (src/gs/render.py:14-129).
# Each maps onto ONE fused pass over the composed scene instead of the
# reference's separate rasterizer invocations.  ``gs_environment`` /
# ``gs_object_list`` take GaussianModel facades or GaussianClouds; the
# object dict's keys are the object ids, and an id beyond the palette
# raises (``rasterize`` keeps no channel for it).  Every wrapper renders
# with ``rasterize`` (the forward kernel on the card); the JAX package
# renders ``render_rgb_and_depth`` with its golden compositor.
# ---------------------------------------------------------------------------


class FrameEncoded(NamedTuple):
    """Device-side encoded frame: exactly the bytes the BOP writer needs (a
    chunk's with a leading [C] axis)."""

    rgb_u8: torch.Tensor  # [H, W, 3] uint8
    depth_mm: torch.Tensor  # [H, W] int32 millimeters in [0, 65535] (BOP uint16)
    mask_visib: torch.Tensor  # [H, W, K] bool
    mask_amodal: torch.Tensor  # [H, W, K] bool
    depth_m: torch.Tensor  # [H, W] float meters (video stream)


def encode_frame(frame: FrameDataPoints) -> FrameEncoded:
    # float -> integer casts truncate toward zero, as the reference's do
    return FrameEncoded(
        rgb_u8=torch.clamp(frame.rgb * 255.0 + 0.5, 0, 255).to(torch.uint8),
        depth_mm=torch.clamp(frame.depth * 1000.0, 0, 65535).to(torch.int32),
        mask_visib=frame.mask_visib,
        mask_amodal=frame.mask_amodal,
        depth_m=frame.depth,
    )


def _packbits(masks: torch.Tensor) -> torch.Tensor:
    """[..., M] bool -> [..., ceil(M/8)] uint8 (little-endian bit order)."""
    m = masks.shape[-1]
    x = torch.nn.functional.pad(masks.to(torch.uint8), (0, (-m) % 8))
    x = x.reshape(*x.shape[:-1], -1, 8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8, device=x.device)
    return torch.sum(x * weights, dim=-1, dtype=torch.int32).to(torch.uint8)


def pack_frame_bytes(enc: FrameEncoded) -> torch.Tensor:
    """Pack an encoded frame into ONE uint8 tensor [H, W, 5 + ceil(2K/8)]
    (a chunk into [C, H, W, 5 + ceil(2K/8)]).

    Channel layout: 0:3 rgb, 3:5 depth_mm (lo, hi bytes), 5: bit-packed
    [visib_0..K-1, amodal_0..K-1].  The semantic image is not shipped: the
    host rebuilds it from the visib bits and the palette."""
    d = enc.depth_mm
    lo = (d & 0xFF).to(torch.uint8)
    hi = (d >> 8).to(torch.uint8)
    bits = _packbits(torch.cat([enc.mask_visib, enc.mask_amodal], dim=-1))
    return torch.cat([enc.rgb_u8, lo[..., None], hi[..., None], bits], dim=-1)


# ---------------------------------------------------------------------------
# Compacted chunk readback: RLE the sparse planes on the device.
#
# The 6 B/px packed frame splits into a dense half (rgb + depth-lo, 4 B/px,
# near-incompressible) and a sparse half (depth-hi + bit-packed masks,
# 2 B/px): the hi byte only changes every 256 mm of depth and the mask
# bytes are zero except where objects project.  The RLE stream lives in a
# fixed budget of ``max_runs`` slots (the reference's layout, kept so that
# both packages write the same bytes) and the uncompressed planes stay on
# the device as a fallback the host fetches only when the run count
# overflows the budget (a dense-noise frame).
# ---------------------------------------------------------------------------


def _unpack_planes(dense, sparse, k: int, palette=None,
                   with_depth_m: bool = True):
    """Decode (dense [...,4] rgb+depth-lo, sparse [...,1+mb] depth-hi+bits)
    plane views into the frame dict (copied from the reference)."""
    rgb = dense[..., 0:3]
    # one allocation + two in-place passes (vs 2 astype copies + shift + or)
    depth_mm = sparse[..., 0].astype(np.uint16)
    depth_mm <<= 8
    depth_mm |= dense[..., 3]
    packed = sparse[..., 1:]
    bits = np.unpackbits(packed, axis=-1, bitorder="little")[..., : 2 * k]
    # unpackbits yields 0/1 uint8: reinterpreting as bool is a zero-copy
    # view, not the two 2x-size astype(bool) copies of the naive path
    visib = bits[..., :k].view(np.bool_)
    amodal = bits[..., k : 2 * k].view(np.bool_)
    if palette is None:
        sem = np.zeros(rgb.shape[:-1] + (3,), np.uint8)
    else:
        pal_u8 = np.clip(
            np.asarray(palette, np.float32)[:k] * 255.0 + 0.5, 0, 255
        ).astype(np.uint8)
        if k <= 8:
            # visib bits all live in mask byte 0 and are mutually
            # exclusive (weights sum <= 1): one 256-entry LUT gather
            # replaces the K-channel tensordot (7.3 -> ~1 ms/frame)
            lut = np.zeros((256, 3), np.uint8)
            for i in range(k):
                lut[1 << i] = pal_u8[i]
            sem = lut[packed[..., 0] & np.uint8((1 << k) - 1)]
        else:
            # masks are mutually exclusive per pixel -> plain sum is exact
            sem = np.tensordot(
                bits[..., :k], pal_u8, axes=([-1], [0])
            ).astype(np.uint8)
    out = {
        "rgb_u8": rgb,
        "sem_u8": sem,
        "depth_mm": depth_mm,
        "mask_visib": visib,
        "mask_amodal": amodal,
    }
    if with_depth_m:
        out["depth_m"] = depth_mm.astype(np.float32) / 1000.0
    return out


def unpack_frame_bytes(buf, k: int, palette=None, with_depth_m: bool = True):
    """Inverse of pack_frame_bytes on a host numpy array (copied from the
    reference): dict(rgb_u8, sem_u8, depth_mm, mask_visib, mask_amodal),
    plus depth_m unless ``with_depth_m=False``."""
    buf = np.asarray(buf)
    return _unpack_planes(
        buf[..., :4], buf[..., 4:], k, palette=palette,
        with_depth_m=with_depth_m,
    )
