"""Modality API: one fused render -> every PEGASUS data point.

Port of ``pegasus_tpu/ops/render.py``.  A single compositor pass yields rgb,
depth, per-object visible masks (environment excluded from occlusion, the
reference's quirk), amodal silhouettes and the semantic image.  Masks are
exact functions of per-object compositing weights; the 0.9 threshold
mirrors the reference's 0.1 colour-distance acceptance.

``encode_frame`` runs on the device, and one uint8 tensor per chunk crosses
to the host in one of three layouts, all giving the same files:

  * writer-ready (``pack_writer_planes`` on the device, ``writer_planes`` on
    the host), ``PEGASUS.generate_dataset``'s default: every plane the BOP
    writer and the video worker read, in the bytes they read them (uint16
    depth, rgb, the semantic image, one 0/255 plane per object mask), so the
    host only slices views.  8 + 2K bytes a pixel;
  * bit-packed (``pack_frame_bytes``, then ``unpack_frame_bytes`` /
    ``_unpack_planes``, the reference's numpy host decode, copied): 5 +
    ceil(2K/8) bytes a pixel.  The sharded generation keeps it, since it
    holds a whole scene per lane in pinned memory until its writer runs;
  * the RLE compact readback (``split_frame_planes``, ``rle_pack_chunk`` on
    the device, ``rle_unpack_chunk`` on the host), the reference's bytes,
    taken with ``PEGASUS(compact_readback=True)``: fewest bytes over the
    link, at the cost of a host decode.

A chunk of C frames (``render_chunk``, the reference's ``lax.map`` chunk
program) carries a leading [C] axis through ``decode_modalities``,
``encode_frame``, ``pack_frame_bytes`` and ``split_frame_planes``, which
work on any leading axes, and ``pack_writer_planes``, which takes a chunk,
so a chunk crosses to the host as one tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pegasus_tpu_torch.camera import Camera, CameraBatch
from pegasus_tpu_torch.gs.cloud import GaussianCloud, merge
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize, rasterize_chunk
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs

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


def render_frame(
    scene: GaussianCloud,
    cam: Camera,
    semantic_colors: torch.Tensor,
    background=(0.0, 0.0, 0.0),
    max_objects: int | None = None,
    rasterize_fn=None,
    **kwargs,
) -> FrameDataPoints:
    """Render every modality for one camera in one pass.  ``max_objects``
    defaults to colours + 1 (channel 0 is the environment).
    ``rasterize_fn`` is called as ``rasterize_fn(scene, cam,
    background=, max_objects=, **kwargs)``; None means ``rasterize`` (the
    forward kernel on the card), where the JAX package's default is its
    golden compositor."""
    if max_objects is None:
        max_objects = semantic_colors.shape[0] + 1
    out = (rasterize if rasterize_fn is None else rasterize_fn)(
        scene, cam, background=background, max_objects=max_objects, **kwargs)
    return decode_modalities(out, semantic_colors)


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


def _as_cloud(x) -> GaussianCloud:
    return x.cloud if hasattr(x, "cloud") else x


def _compose(gs_environment, gs_object_list) -> tuple[GaussianCloud, int]:
    """(merged scene with object_id = the dict key, largest id)."""
    parts = [_as_cloud(gs_environment).with_object_id(0)]
    for oid, obj in gs_object_list.items():
        parts.append(_as_cloud(obj).with_object_id(int(oid)))
    return merge(parts), max(gs_object_list.keys(), default=0)


def _render_composed(cam, gs_environment, gs_object_list, color_set, bg) -> FrameDataPoints:
    scene, max_id = _compose(gs_environment, gs_object_list)
    colors = torch.zeros((max_id, 3)) if color_set is None else color_set
    colors = torch.as_tensor(colors, dtype=torch.float32, device=scene.device)
    return render_frame(scene, cam, colors, background=bg)


def render_rgb_and_depth(cam, gs_scene, pipe_settings=None, bg=(0, 0, 0), debug=False):
    """(rgb [H, W, 3], depth [H, W, 1]) like the reference (render.py:14-33).
    Colour and depth need no object channels, so the scene renders with
    its ids set to 0 and K = 1."""
    out = rasterize(_as_cloud(gs_scene).with_object_id(0), cam, background=bg, max_objects=1)
    return torch.clamp(out.rgb, 0, 1), out.depth[..., None]


def render_visib_mask(cam, gs_environment, gs_object_list, color_set, height=None, width=None,
                      pipe_settings=None, bg=(0, 0, 0)):
    """(per-object visible masks [H, W, K], seg colour image): environment
    splats are left out of the occlusion, the reference's quirk
    (render.py:68-97), but the masks are decoded from exact weights."""
    frame = _render_composed(cam, gs_environment, gs_object_list, color_set, bg)
    return frame.mask_visib, frame.seg_image


def render_silhouette_mask(cam, gs_object_list, gs_env, width=None, height=None, color_set=None,
                           pipe_settings=None, bg=(0, 0, 0)):
    """Per-object amodal masks [H, W, K] (reference: render.py:36-65, one
    CUDA pass per object there; one fused pass here)."""
    return _render_composed(cam, gs_env, gs_object_list, color_set, bg).mask_amodal


def render_semanticsegmentation_mask(cam, gs_environment, gs_object_list, color_set, height=None,
                                     width=None, pipe_settings=None, bg=(0, 0, 0), debug=False):
    """uint8 semantic colour image as a host array (reference:
    render.py:100-129)."""
    frame = _render_composed(cam, gs_environment, gs_object_list, color_set, bg)
    return (frame.seg_image * 255).to(torch.uint8).cpu().numpy()


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


def palette_u8(palette, k: int) -> np.ndarray:
    """The semantic image's colours of object ids 1..k, uint8 [k, 3] (the
    reference's rounding)."""
    return np.clip(np.asarray(palette, np.float32)[:k] * 255.0 + 0.5, 0, 255).astype(np.uint8)


def writer_frame_bytes(height: int, width: int, k: int) -> int:
    """Bytes of one frame in the writer-ready layout."""
    return height * width * (8 + 2 * k)


def pack_writer_planes(enc: FrameEncoded, colors_u8: torch.Tensor) -> torch.Tensor:
    """A chunk's encoded frames (leading [C] axis) in the writer-ready
    layout: ONE uint8 tensor [C, H*W*(8 + 2K)] in which each frame is,
    plane after contiguous plane, depth_mm ([H, W] uint16 little-endian),
    rgb_u8 ([H, W, 3]), sem_u8 ([H, W, 3]), then one 0/255 [H, W] plane per
    visible and then per amodal object mask.  ``colors_u8`` is
    ``palette_u8`` [K, 3] on the device.  Every byte is the one that
    ``unpack_frame_bytes(pack_frame_bytes(enc))`` decodes: the semantic
    image is the host LUT's for K <= 8 (the colour of the one visible
    object, black where none or several are) and ``tensordot``'s for K > 8
    (the visible objects' colours summed modulo 256)."""
    vis, amodal = enc.mask_visib, enc.mask_amodal
    c, h, w, k = vis.shape
    hw = h * w
    buf = torch.empty((c, writer_frame_bytes(h, w, k)), dtype=torch.uint8, device=vis.device)
    # the int32 depth's two low bytes (little-endian on the host and the card)
    buf[:, : 2 * hw].view(c, h, w, 2).copy_(enc.depth_mm.view(torch.uint8).view(c, h, w, 4)[..., :2])
    buf[:, 2 * hw : 5 * hw].view(c, h, w, 3).copy_(enc.rgb_u8)
    vis_f = vis.to(torch.float32)
    sem = vis_f @ colors_u8.to(torch.float32)  # sums of integers below 2**24: exact
    if k <= 8:
        sem = torch.where(vis_f.sum(-1, keepdim=True) == 1, sem, 0.0)
    else:
        sem = torch.remainder(sem, 256.0)
    buf[:, 5 * hw : 8 * hw].view(c, h, w, 3).copy_(sem)
    masks = buf[:, 8 * hw :].view(c, 2, k, h, w)
    masks[:, 0].copy_(vis.permute(0, 3, 1, 2))
    masks[:, 1].copy_(amodal.permute(0, 3, 1, 2))
    masks.mul_(255)
    return buf


def writer_planes(buf, height: int, width: int, k: int) -> dict:
    """``pack_writer_planes``' bytes on the host as views, nothing copied:
    ``unpack_frame_bytes``' keys (depth_m aside) with a leading [C] axis,
    the masks as 0/255 uint8 planes [C, K, H, W].  Each frame's planes are
    C-contiguous."""
    hw = height * width
    b = np.asarray(buf).reshape(-1, writer_frame_bytes(height, width, k))
    c = b.shape[0]
    masks = b[:, 8 * hw :].reshape(c, 2, k, height, width)
    return {
        "rgb_u8": b[:, 2 * hw : 5 * hw].reshape(c, height, width, 3),
        "sem_u8": b[:, 5 * hw : 8 * hw].reshape(c, height, width, 3),
        "depth_mm": b[:, : 2 * hw].view(np.uint16).reshape(c, height, width),
        "mask_visib": masks[:, 0],
        "mask_amodal": masks[:, 1],
    }


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

RLE_HEADER_BYTES = 8  # n_runs u32 | n_elements u32 (little-endian)
RLE_BYTES_PER_RUN = 5  # value u8 | start offset u32 (little-endian)


def rle_max_runs(chunk: int, height: int, width: int, n_planes: int) -> int:
    """Default run budget: stream_bytes/48 runs -> 5/48 ~ 0.10 B per plane
    byte, i.e. a ~31% cut of the 6 B/px frame when n_planes = 2."""
    return max(1024, (chunk * height * width * n_planes) // 48)


def split_frame_planes(enc: FrameEncoded) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoded frame -> (dense [H,W,4] rgb+depth-lo, sparse [H,W,1+mb]
    depth-hi+maskbits), with a leading [C] for a chunk.  Concatenating (dense, sparse) channel-wise gives
    exactly the pack_frame_bytes layout."""
    d = enc.depth_mm
    lo = (d & 0xFF).to(torch.uint8)
    hi = (d >> 8).to(torch.uint8)
    bits = _packbits(torch.cat([enc.mask_visib, enc.mask_amodal], dim=-1))
    dense = torch.cat([enc.rgb_u8, lo[..., None]], dim=-1)
    sparse = torch.cat([hi[..., None], bits], dim=-1)
    return dense, sparse


def _u32_bytes(x: torch.Tensor) -> torch.Tensor:
    """Non-negative integers below 2**32 [...] -> little-endian uint8
    [..., 4] (computed in int64: torch has no general uint32 arithmetic)."""
    x = x.to(torch.int64)
    return torch.stack([((x >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(4)], dim=-1)


def rle_pack_chunk(dense: torch.Tensor, sparse: torch.Tensor, max_runs: int):
    """Pack a chunk ([C,H,W,4] dense, [C,H,W,P] sparse) into ONE uint8
    transfer buffer + the raw sparse planes as overflow fallback.

    Buffer layout: [8B header | 5*max_runs RLE slots | dense bytes].
    The sparse planes are flattened PLANE-major ([P,C,H,W]) so each mask
    byte-plane and the depth-hi plane keep their long spatial runs.  The
    header reports the run count BEFORE the budget cuts it, which is how
    the host learns of an overflow.  Returns (buf [8+5*max_runs+dense.size]
    u8, sparse): the caller ships ``buf`` and fetches ``sparse`` only if the
    header reports overflow.
    """
    dev = sparse.device
    x = sparse.permute(3, 0, 1, 2).reshape(-1)
    n = x.shape[0]
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), x[1:] != x[:-1]])
    rid = torch.cumsum(start.to(torch.int64), 0) - 1
    n_runs = rid[-1] + 1
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    # one scatter per run start; everything else, runs past the budget
    # included, lands in a slot one past the end that is cut off
    idx = torch.where(start & (rid < max_runs), rid, torch.full_like(rid, max_runs))
    starts = torch.zeros(max_runs + 1, dtype=torch.int64, device=dev)
    starts[idx] = pos
    starts = starts[:max_runs]
    values = x[starts]
    rle = torch.cat([values[:, None], _u32_bytes(starts)], dim=-1).reshape(-1)
    header = torch.cat(
        [_u32_bytes(n_runs), _u32_bytes(torch.tensor(n, dtype=torch.int64, device=dev))], dim=-1
    ).reshape(-1)
    buf = torch.cat([header, rle, dense.reshape(-1)])
    return buf, sparse


def rle_unpack_chunk(buf, chunk_shape, k: int, max_runs: int, palette=None,
                     fallback_sparse=None, with_depth_m: bool = True):
    """Host inverse of rle_pack_chunk (copied from the reference).

    chunk_shape = (C, H, W); ``fallback_sparse`` is a zero-arg callable
    returning the raw sparse planes [C,H,W,P] (e.g. lambda fetching the
    device tensor) used when the run count overflowed the budget.
    Returns the unpack_frame_bytes dict with a leading chunk axis.
    """
    c, h, w = chunk_shape
    mb = (2 * k + 7) // 8
    p = 1 + mb
    buf = np.asarray(buf)
    n_runs, n = np.frombuffer(
        buf[:RLE_HEADER_BYTES].tobytes(), dtype="<u4"
    )
    rle_end = RLE_HEADER_BYTES + RLE_BYTES_PER_RUN * max_runs
    if n_runs > max_runs:
        if fallback_sparse is None:
            raise ValueError(
                f"RLE overflow ({n_runs} runs > budget {max_runs}) and no "
                "fallback provided"
            )
        sparse = np.asarray(fallback_sparse())
    else:
        rle = buf[RLE_HEADER_BYTES:rle_end].reshape(max_runs,
                                                    RLE_BYTES_PER_RUN)
        values = rle[:n_runs, 0]
        starts = (
            rle[:n_runs, 1:5].astype(np.uint32)
            * np.uint32([1, 1 << 8, 1 << 16, 1 << 24])
        ).sum(axis=1)
        lengths = np.diff(starts, append=np.uint32(n)).astype(np.int64)
        flat = np.repeat(values, lengths)
        sparse = flat.reshape(p, c, h, w).transpose(1, 2, 3, 0)
    dense = buf[rle_end:].reshape(c, h, w, 4)
    # (dense, sparse) channel-concat == the pack_frame_bytes layout, but
    # the planes are consumed as views — no per-chunk concat copy
    return _unpack_planes(
        dense, sparse, k, palette=palette, with_depth_m=with_depth_m
    )


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
        pal_u8 = palette_u8(palette, k)
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
