"""Frozen copy of pegasus_tpu_torch/ops/binning.py at commit 7a69f88.

Exact tile binning: projected splats -> depth-ordered per-tile entry lists.

Replaces ``pegasus_tpu/ops/binning.py::bin_splats``.  Every on-screen splat
emits one entry per tile of its clipped 3-sigma tile bbox (the reference's
floor/clip/onscreen rule, binning.py:331-345):

  1. count each splat's clipped bbox area and take the exclusive prefix
     sum, which gives every splat its run of entries;
  2. expand with ``repeat_interleave`` and build an int64 key
     ``tile << 32 | float-bits(depth)`` (a positive float's bit pattern is
     monotone in its value, and projection near-culls at z > 0.2);
  3. ``torch.sort(stable=True)``: entries are generated in splat order, so
     ties in depth keep the splat index as tiebreak, like the reference's
     (key, src) sort;
  4. per-tile [start, start + count) from ``searchsorted`` on the tile ids.

The entry count is exactly the sum of the clipped bbox areas, so nothing
can be truncated.

A chunk of C frames (``ProjectedGaussians`` of [C, N] columns) bins in one
pass: frame f's splat s is splat f * N + s of the chunk, its tiles are
tiles f * n_tiles .. (f + 1) * n_tiles - 1, and the key is
``(f * n_tiles + tile) << 32 | float-bits(depth)``, so one stable sort
orders every frame's entries exactly as binning that frame alone would,
and one host read sizes the whole chunk.  The reference's TPU-only machinery is dropped: the
static-cap a_small / mid / big slot buckets and their footprint clamp,
``entry_cap`` and the overflow flag, the PACKED8 fixed-point rows
(binning.py:1-31, 57-76) and the ``_gather_rows_structured`` VJP (a
workaround for TPU scatter cost: the training backward,
``ops/composite_vjp.py``, sums per-entry gradients into their splats with a
segmented sum over ``splat_order``, and ``pack_params`` differentiates under
autograd).

The compositor reads one table of per-splat parameters, struct-of-arrays
``params[f, splat]`` (rows ``P_*`` below), through ``entry_splat``: each
entry is the index of its splat, and the kernel gathers the fields while
staging a batch into shared memory, so no per-entry copy of the parameters
is written.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.frozen.ops.projection import ProjectedGaussians

TILE = 16

# row index in TileBins.params (struct-of-arrays over splats)
PARAM_DIM = 12
P_MX, P_MY = 0, 1
P_CA, P_CB, P_CC = 2, 3, 4
P_OPAC = 5
P_R, P_G, P_B = 6, 7, 8
P_DEPTH = 9
P_RADIUS = 10
P_OBJ = 11  # object id as an exact small float


class TileBins(NamedTuple):
    """Depth-ordered per-tile entry segments over a per-splat parameter table.

    Tile t's entries are entry_splat[tile_start[t] : tile_start[t] +
    tile_count[t]], front to back.  Tiles are row-major within a frame and
    frames follow each other: t = (frame * n_tiles_y + ty) * n_tiles_x + tx;
    splats likewise, N per frame.  The segments fill entry_splat from the
    front; entries past sum(tile_count) belong to no tile (the entries that
    ``cap_bins`` dropped), and splat_order / splat_count cover only the
    entries in segments.
    """

    params: torch.Tensor  # [PARAM_DIM, n_frames * N] float32
    entry_splat: torch.Tensor  # [M] int32 splat index per entry
    tile_start: torch.Tensor  # [n_frames * n_tiles] int32
    tile_count: torch.Tensor  # [n_frames * n_tiles] int32
    n_tiles_x: int
    n_tiles_y: int
    max_object_id: int  # largest object id among binned splats (-1 if none)
    # the entries grouped by splat, each splat's in entry order
    # (entry_splat[splat_order] is sorted, stably), then the entries in no
    # segment; and each splat's count of entries in segments: the backward
    # sums a splat's gradients in this fixed order instead of with atomics
    splat_order: torch.Tensor  # [M] int64
    splat_count: torch.Tensor  # [n_frames * N] int64
    n_frames: int = 1


def tile_bboxes(proj: ProjectedGaussians, width: int, height: int, tile: int = TILE):
    """Clipped tile bbox (tx0, ty0, w, h) and area per splat; area is 0 for
    splats that are invalid or wholly off screen."""
    ntx = -(-width // tile)
    nty = -(-height // tile)
    mx, my, r = proj.mean_x, proj.mean_y, proj.radius

    def tile_of(v, n):
        return torch.clamp(torch.floor(v / tile), 0, n - 1).to(torch.int64)

    tx0, tx1 = tile_of(mx - r, ntx), tile_of(mx + r, ntx)
    ty0, ty1 = tile_of(my - r, nty), tile_of(my + r, nty)
    onscreen = (
        proj.valid
        & (mx + r >= 0) & (mx - r < width)
        & (my + r >= 0) & (my - r < height)
    )
    w_t = tx1 - tx0 + 1
    h_t = ty1 - ty0 + 1
    area = torch.where(onscreen, w_t * h_t, torch.zeros_like(w_t))
    return tx0, ty0, w_t, area


def pack_params(proj: ProjectedGaussians) -> torch.Tensor:
    """[PARAM_DIM, N] float32 parameter table (P_* row order)."""
    return torch.stack(
        [
            proj.mean_x, proj.mean_y,
            proj.conic_a, proj.conic_b, proj.conic_c,
            proj.opacity,
            proj.color_r, proj.color_g, proj.color_b,
            proj.depth,
            proj.radius,
            proj.object_id.to(torch.float32),
        ],
        dim=0,
    ).contiguous()


def bin_splats(
    proj: ProjectedGaussians, width: int, height: int, tile: int = TILE
) -> TileBins:
    """Bin one frame ([N] columns) or a chunk of C frames ([C, N] columns)."""
    dev = proj.mean_x.device
    ntx = -(-width // tile)
    nty = -(-height // tile)
    n_tiles = ntx * nty
    n = proj.mean_x.shape[-1]
    n_frames = proj.mean_x.shape[0] if proj.mean_x.dim() == 2 else 1
    if proj.mean_x.dim() == 2:
        proj = ProjectedGaussians(*(f.reshape(-1) for f in proj))

    tx0, ty0, w_t, area = tile_bboxes(proj, width, height, tile)
    live_obj = torch.where(area > 0, proj.object_id.to(torch.int64), -1)
    obj_max = torch.cat([live_obj, live_obj.new_full((1,), -1)]).max()
    # the one host sync of a frame or chunk: the entry count sizes the expansion
    m, max_object_id = torch.stack([area.sum(), obj_max]).tolist()
    bin_splats.host_reads += 1

    splat = torch.repeat_interleave(torch.arange(n_frames * n, device=dev), area, output_size=m)
    first = torch.cumsum(area, 0) - area  # exclusive prefix sum
    j = torch.arange(m, device=dev) - first[splat]  # entry's rank in its bbox
    w_s = w_t[splat]
    tile_id = (ty0[splat] + j // w_s) * ntx + tx0[splat] + j % w_s
    if n_frames > 1:
        tile_id += (splat // n) * n_tiles

    depth_bits = proj.depth.contiguous().view(torch.int32).to(torch.int64)[splat]
    key = (tile_id << 32) | depth_bits
    sorted_key, order = torch.sort(key, stable=True)
    entry_splat = splat[order].to(torch.int32)

    # entries were generated in splat order and, within a splat, in tile
    # order, so inverting the sort groups them by splat in entry order
    splat_order = torch.empty_like(order)
    splat_order[order] = torch.arange(m, device=dev)

    bounds = torch.searchsorted(
        sorted_key >> 32, torch.arange(n_frames * n_tiles + 1, device=dev, dtype=torch.int64)
    )
    return TileBins(
        params=pack_params(proj),
        entry_splat=entry_splat,
        tile_start=bounds[:-1].to(torch.int32),
        tile_count=(bounds[1:] - bounds[:-1]).to(torch.int32),
        n_tiles_x=ntx,
        n_tiles_y=nty,
        max_object_id=max_object_id,
        splat_order=splat_order,
        splat_count=area,
        n_frames=n_frames,
    )


bin_splats.host_reads = 0  # blocking device-to-host reads, one per call


def _partition(keep: torch.Tensor, n_keep: torch.Tensor) -> torch.Tensor:
    """Each element's slot when the ``keep`` ones move to the front and the
    others after them, both in their order (``n_keep`` = keep.sum(), on the
    device)."""
    before = torch.cumsum(keep, 0) - keep.long()  # kept elements before this one
    index = torch.arange(keep.numel(), device=keep.device)
    return torch.where(keep, before, n_keep + index - before)


def cap_bins(bins: TileBins, max_per_tile: int) -> TileBins:
    """Bins that keep each tile's first ``max_per_tile`` entries, front to
    back (every tile of every frame of a chunk), and drop the rest.

    The kept entries are compacted to the front of ``entry_splat`` in their
    order and the dropped ones follow them, in no tile's segment: every
    array keeps its length, so nothing is read back to the host to size it.
    ``tile_start`` and ``tile_count`` are recomputed, and ``splat_order`` /
    ``splat_count`` rebuilt over the kept entries, so the backward's
    per-entry rows and its sum to splats see the kept entries only.  A cap
    at or above the longest segment gives bins equal to ``bins``."""
    if max_per_tile < 1:
        raise ValueError(f"max_per_tile={max_per_tile} < 1")
    dev = bins.entry_splat.device
    m = bins.entry_splat.numel()
    count = bins.tile_count.long()
    kept_count = torch.clamp(count, max=max_per_tile)
    # each entry's tile (count.numel() past the last segment) and its rank there
    entry = torch.arange(m, device=dev)
    tile = torch.searchsorted(torch.cumsum(count, 0), entry, right=True)
    in_segment = tile < count.numel()
    start = bins.tile_start.long()[torch.clamp(tile, max=count.numel() - 1)]
    keep = in_segment & (entry - start < max_per_tile)
    n_keep = kept_count.sum()
    dst = _partition(keep, n_keep)
    entry_splat = torch.empty_like(bins.entry_splat)
    entry_splat[dst] = bins.entry_splat
    # splat_order: the entries' new places, grouped by splat as before, with
    # the dropped ones moved behind every kept one
    keep_grouped = keep[bins.splat_order]
    splat_order = torch.empty_like(bins.splat_order)
    splat_order[_partition(keep_grouped, n_keep)] = dst[bins.splat_order]
    splat_count = torch.zeros_like(bins.splat_count).scatter_add_(
        0, bins.entry_splat.long(), keep.long())
    return bins._replace(
        entry_splat=entry_splat,
        tile_start=(torch.cumsum(kept_count, 0) - kept_count).to(torch.int32),
        tile_count=kept_count.to(torch.int32),
        splat_order=splat_order,
        splat_count=splat_count,
    )
