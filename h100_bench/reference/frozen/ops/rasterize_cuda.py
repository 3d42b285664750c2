"""Frozen copy of pegasus_tpu_torch/ops/rasterize_cuda.py at commit 7a69f88, without the kernel's build and launch: ``composite_tiles`` runs ``composite_tiles_torch`` on every device; cut to what the benchmark calls.

Tile-compositing rasterizer: project -> exact bin -> CUDA composite.

Replaces ``pegasus_tpu/ops/rasterize_pallas.py`` (``rasterize_pallas`` and
``composite_tiles_pallas``).  ``composite_tiles`` launches the hand-written
sm_90a kernel ``csrc/composite_tiles.cu`` for CUDA tensors and runs its
plain torch version, ``composite_tiles_torch``, for CPU tensors; there is
no fallback from one to the other.  The TPU knobs are dropped:
``tiles_per_program``, ``chunk``, ``pack_params`` and the binning
budgets / caps exist for Mosaic's static shapes and VMEM windows
(rasterize_pallas.py:379-528), and exact binning has none of them.

Source note for the kernel (what bounds it on an H100 and what the design
does about it) is at the top of ``csrc/composite_tiles.cu``.  The kernel
cuts every tile's segment into work items of at most ``CHUNK_ENTRIES``
entries, one block each, and combines the items of a tile in order; the
plain version composites and combines with the same association, so the
CPU tests exercise the combine too.  Bins of a chunk of C frames
(``bin_splats`` of [C, N] columns, ``TileBins.n_frames``) composite in one
launch, or one plain call, into [C, H, W, F]; ``rasterize_chunk`` renders a
``CameraBatch`` that way.

Output channels of both versions, per pixel ([H, W, F], F = 5 + 3K + 2):
  0:3 rgb (premultiplied, no background), 3 depth, 4 alpha, 5:5+K seg,
  5+K:5+2K vis (environment excluded), 5+2K:5+3K amodal log-transmittance,
  5+3K t_full, 5+3K+1 t_noenv.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.frozen.camera import Camera, CameraBatch
from reference.frozen.gs.cloud import GaussianCloud
from reference.frozen.ops import binning as B
from reference.frozen.ops.binning import TileBins, bin_splats
from reference.frozen.ops.projection import project_gaussians
from reference.frozen.ops.rasterize_ref import RenderOutputs

# Entries per work item, C: segments longer than this are split across
# blocks.  At the 210k-splat orbit view (mean 466 entries per tile, p99
# 4,359, max 5,738) C = 256 makes 2,874 items of 1,200 tiles, and at the
# training shape (mean 408, max 2,875) 2,532 of 1,024.  chip_smoke.py times
# both kernels at C = 128, 256, 512 and 1024; PERF.md has the times and
# why 256.
CHUNK_ENTRIES = 256



def num_channels(max_objects: int) -> int:
    return 5 + 3 * max_objects + 2




def max_items(n_entries: int, n_tiles: int, chunk_entries: int) -> int:
    """Bound on the work items of ``n_tiles`` tiles (a frame's, or a
    chunk's), from sizes the host knows: every tile holds max(1, ceil(count
    / C)) <= count / C + 1 items."""
    return -(-n_entries // chunk_entries) + n_tiles


def tile_items(bins: TileBins, chunk_entries: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(items per tile, index of each tile's first item), int64 [C * n_tiles]:
    the numbering both kernels derive on the device (composite_common.cuh)."""
    count = bins.tile_count.long()
    n = torch.where(count > chunk_entries, -(-count // chunk_entries), torch.ones_like(count))
    return n, torch.cumsum(n, 0) - n


def partials_shape(bins: TileBins, max_objects: int, chunk_entries: int) -> tuple[int, int, int]:
    """[items bound, F, 256]: one row of per-pixel partials per work item."""
    n_tiles = bins.n_frames * bins.n_tiles_x * bins.n_tiles_y
    return (max_items(bins.entry_splat.numel(), n_tiles, chunk_entries),
            num_channels(max_objects), B.TILE * B.TILE)


def out_shape(bins: TileBins, width: int, height: int, max_objects: int) -> tuple:
    """[H, W, F] for one frame's bins, [C, H, W, F] for a chunk's."""
    frames = (bins.n_frames,) if bins.n_frames > 1 else ()
    return (*frames, height, width, num_channels(max_objects))


def _check_bins(bins: TileBins, width: int, height: int, max_objects: int) -> None:
    if (bins.n_tiles_x, bins.n_tiles_y) != (-(-width // B.TILE), -(-height // B.TILE)):
        raise ValueError(
            f"bins cover {bins.n_tiles_x}x{bins.n_tiles_y} tiles, not a {width}x{height} image"
        )
    if max_objects < 1:
        raise ValueError(f"max_objects={max_objects} < 1")
    if bins.max_object_id >= max_objects:
        raise ValueError(
            f"object id {bins.max_object_id} >= max_objects={max_objects}: "
            "its seg/vis/amodal channel would be dropped"
        )
    n_tiles = bins.n_frames * bins.n_tiles_x * bins.n_tiles_y
    expect = {
        "params": (bins.params, torch.float32, (B.PARAM_DIM, bins.params.shape[1])),
        "entry_splat": (bins.entry_splat, torch.int32, (bins.entry_splat.numel(),)),
        "tile_start": (bins.tile_start, torch.int32, (n_tiles,)),
        "tile_count": (bins.tile_count, torch.int32, (n_tiles,)),
    }
    dev = bins.params.device
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, params on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )


def composite_tiles(
    bins: TileBins, width: int, height: int, max_objects: int,
    chunk_entries: int = CHUNK_ENTRIES, return_partials: bool = False,
):
    """Composite every tile's entries front to back -> [H, W, F] float32
    ([C, H, W, F] for a chunk's bins, in one launch), or (out, partials)
    with ``return_partials``: the per-item partials
    ``composite_tiles_backward`` needs (rows of tiles of more than one item;
    shape ``partials_shape``).

    Every device runs ``composite_tiles_torch`` (this copy holds no kernel)."""
    _check_bins(bins, width, height, max_objects)
    if chunk_entries < 1:
        raise ValueError(f"chunk_entries={chunk_entries} < 1")
    return composite_tiles_torch(bins, width, height, max_objects,
                                 chunk_entries=chunk_entries, return_partials=return_partials)


class TileChunk(NamedTuple):
    """One step of the plain versions: entries [lo, lo + C) of every tile
    still holding that many, and each (pixel, entry) pair's alpha."""

    lo: int  # first entry of the step, counted from each tile's start
    act: torch.Tensor  # [A] tiles with entries left
    ok: torch.Tensor  # [A, C] the entry exists
    idx: torch.Tensor  # [A, C] its index in entry_splat (0 where not ok)
    p: torch.Tensor  # [PARAM_DIM, A, C] its splat's parameters
    px: torch.Tensor  # [A, PX] pixel x (int64)
    py: torch.Tensor  # [A, PX] pixel y
    dx: torch.Tensor  # [A, PX, C] pixel - mean
    dy: torch.Tensor
    exppow: torch.Tensor  # exp(min(power, 0))
    raw: torch.Tensor  # opacity * exppow, before the 0.99 clamp
    alpha: torch.Tensor  # min(raw, 0.99)
    keep: torch.Tensor  # the kernels' keep rule, and ok


def tile_chunks(bins: TileBins, chunk: int, chunk_entries: int | None = None):
    """Walk every tile's segment ``chunk`` entries at a time, vectorised
    over tiles, with the kernels' alpha expressions (composite_common.cuh:
    the same products and sums, left to right).  With ``chunk_entries`` no
    step crosses a work item's boundary (a multiple of it)."""
    dev = bins.params.device
    ntx, n_tiles = bins.n_tiles_x, bins.tile_count.numel()
    lin = torch.arange(B.TILE * B.TILE, device=dev)
    local = torch.arange(n_tiles, device=dev) % (ntx * bins.n_tiles_y)  # the tile in its frame
    pxs = (local % ntx)[:, None] * B.TILE + lin % B.TILE
    pys = (local // ntx)[:, None] * B.TILE + lin // B.TILE
    start = bins.tile_start.long()
    count = bins.tile_count.long()
    entry_splat = bins.entry_splat.long()
    max_count = int(count.max()) if n_tiles else 0
    lo = 0
    while lo < max_count:
        width = chunk
        if chunk_entries is not None:
            width = min(chunk, (lo // chunk_entries + 1) * chunk_entries - lo)
        act = torch.nonzero(count > lo)[:, 0]
        e = lo + torch.arange(width, device=dev)
        ok = e[None, :] < count[act, None]  # [A, C]
        idx = torch.where(ok, start[act, None] + e[None, :], 0)
        p = bins.params[:, entry_splat[idx]]  # [F, A, C]
        px, py = pxs[act], pys[act]
        dx = px.to(torch.float32)[:, :, None] - p[B.P_MX][:, None, :]  # [A, PX, C]
        dy = py.to(torch.float32)[:, :, None] - p[B.P_MY][:, None, :]
        ca, cb, cc = (p[r][:, None, :] for r in (B.P_CA, B.P_CB, B.P_CC))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        exppow = torch.exp(torch.clamp(power, max=0.0))
        raw = p[B.P_OPAC][:, None, :] * exppow
        alpha = torch.clamp(raw, max=0.99)
        rad = p[B.P_RADIUS][:, None, :]
        keep = (
            (power <= 0.0) & (alpha >= 1.0 / 255.0)
            & (torch.abs(dx) <= rad) & (torch.abs(dy) <= rad) & ok[:, None, :]
        )
        yield TileChunk(lo, act, ok, idx, p, px, py, dx, dy, exppow, raw, alpha, keep)
        lo += width


def over(acc: torch.Tensor, part: torch.Tensor, k: int) -> torch.Tensor:
    """Composite ``part`` behind ``acc`` ([..., F] in the output's channel
    order, each composited from T = 1): the combine of two work items."""
    t, t_ne = acc[..., 5 + 3 * k, None], acc[..., 5 + 3 * k + 1, None]
    return torch.cat([
        acc[..., : 5 + k] + t * part[..., : 5 + k],
        acc[..., 5 + k : 5 + 2 * k] + t_ne * part[..., 5 + k : 5 + 2 * k],
        acc[..., 5 + 2 * k : 5 + 3 * k] + part[..., 5 + 2 * k : 5 + 3 * k],
        t * part[..., 5 + 3 * k, None],
        t_ne * part[..., 5 + 3 * k + 1, None],
    ], dim=-1)


def composite_tiles_torch(
    bins: TileBins, width: int, height: int, max_objects: int, chunk: int = 64,
    chunk_entries: int = CHUNK_ENTRIES, return_partials: bool = False,
):
    """Plain torch version of the kernel, same inputs and outputs.

    Vectorised over tiles (``tile_chunks``; every frame's of a chunk): each
    step composites a chunk of entries with an exclusive cumulative product
    of (1 - alpha) and carries the transmittances to the next step.  Like
    the kernel, each work item of ``chunk_entries`` entries composites from
    T = 1 and is combined into its tile's result in order (``over``)."""
    _check_bins(bins, width, height, max_objects)
    dev = bins.params.device
    k = max_objects
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    n_tiles = bins.tile_count.numel()
    px_n = B.TILE * B.TILE

    count = bins.tile_count.long()
    multi = count > chunk_entries
    _, first = tile_items(bins, chunk_entries)
    partials = torch.zeros(partials_shape(bins, k, chunk_entries), device=dev)
    identity = torch.cat([torch.zeros(n_tiles, px_n, 5 + 3 * k, device=dev),
                          torch.ones(n_tiles, px_n, 2, device=dev)], dim=-1)
    total = identity

    def fresh():
        """The current item's state: t_full, t_ne, A and vis sums, amodal log."""
        return (torch.ones(n_tiles, px_n, device=dev), torch.ones(n_tiles, px_n, device=dev),
                torch.zeros(n_tiles, px_n, 5 + 2 * k, device=dev),
                torch.zeros(n_tiles, px_n, k, device=dev))

    def finish(item, state):
        """Item ``item`` of every tile that has it is done: keep its
        partials (tiles of several items) and combine it in order."""
        t_full, t_ne, acc, amodal_log = state
        part = torch.cat([acc, amodal_log, t_full[..., None], t_ne[..., None]], dim=-1)
        rows = multi & (count > item * chunk_entries)
        partials[first[rows] + item] = part[rows].transpose(1, 2)
        return over(total, part, k)

    kk = torch.arange(k, device=dev)
    item, state = 0, fresh()
    for c in tile_chunks(bins, chunk, chunk_entries):
        if c.lo // chunk_entries > item:
            total = finish(item, state)
            item, state = c.lo // chunk_entries, fresh()
        t_full, t_ne, acc, amodal_log = state
        act, p = c.act, c.p
        a = torch.where(c.keep, c.alpha, torch.zeros_like(c.alpha))

        obj = p[B.P_OBJ].long()  # [A, C]
        onehot = (obj[..., None] == kk).to(torch.float32)  # [A, C, K]
        feat = torch.cat(
            [p[[B.P_R, B.P_G, B.P_B, B.P_DEPTH]].permute(1, 2, 0),
             torch.ones_like(onehot[..., :1]), onehot],
            dim=-1,
        )  # [A, C, 5 + K]

        def chain(a_c, t0):
            keep_frac = torch.cumprod(1.0 - a_c, dim=-1)
            excl = torch.cat([torch.ones_like(keep_frac[..., :1]), keep_frac[..., :-1]], -1)
            return a_c * excl * t0[:, :, None], t0 * keep_frac[..., -1]

        w_full, t_full[act] = chain(a, t_full[act])
        a_ne = torch.where((obj == 0)[:, None, :], torch.zeros_like(a), a)
        w_ne, t_ne[act] = chain(a_ne, t_ne[act])
        acc[act] += torch.cat(
            [torch.bmm(w_full, feat), torch.bmm(w_ne, onehot)], dim=-1
        )
        amodal_log[act] += torch.bmm(torch.log1p(-a), onehot)
    total = finish(item, state)

    out = total.reshape(bins.n_frames, nty, ntx, B.TILE, B.TILE, -1).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(bins.n_frames, nty * B.TILE, ntx * B.TILE, -1)[:, :height, :width]
    out = out.reshape(out_shape(bins, width, height, k)).contiguous()
    return (out, partials) if return_partials else out


def outputs_from_channels(out: torch.Tensor, background, max_objects: int) -> RenderOutputs:
    """[H, W, F] compositor channels -> RenderOutputs, blending the
    background behind the remaining transmittance."""
    k = max_objects
    bg = torch.as_tensor(background, dtype=torch.float32, device=out.device)
    t_full = out[..., 5 + 3 * k]
    return RenderOutputs(
        rgb=out[..., 0:3] + t_full[..., None] * bg,
        depth=out[..., 3],
        alpha=out[..., 4],
        seg_weights=out[..., 5 : 5 + k],
        vis_weights=out[..., 5 + k : 5 + 2 * k],
        amodal=1.0 - torch.exp(out[..., 5 + 2 * k : 5 + 3 * k]),
    )


def rasterize(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
) -> RenderOutputs:
    """Drop-in alternative to ``rasterize_reference`` (same RenderOutputs)."""
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    bins = bin_splats(proj, cam.width, cam.height)
    out = composite_tiles(bins, cam.width, cam.height, max_objects)
    return outputs_from_channels(out, background, max_objects)


def rasterize_chunk(
    cloud: GaussianCloud,
    cams: CameraBatch,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
) -> RenderOutputs:
    """``rasterize`` of C cameras at once -> RenderOutputs with a leading
    [C] axis: one projection, one binning (one host read) and one
    compositor launch for the chunk.  ``cloud`` is one posed scene, or a
    scene posed C ways (one pose per camera).  Each frame has the bits of
    ``rasterize`` of its camera on the same device."""
    proj = project_gaussians(cloud, cams, sh_degree, scaling_modifier)
    bins = bin_splats(proj, cams.width, cams.height)
    out = composite_tiles(bins, cams.width, cams.height, max_objects)
    out = out.reshape(len(cams), cams.height, cams.width, -1)
    return outputs_from_channels(out, background, max_objects)

