"""Splat-axis model parallelism for the rasterizer.

Port of ``pegasus_tpu/parallel/sharded_render.py``.  Front-to-back alpha
compositing is associative under the 'over' operator:

    (c1, T1) over (c2, T2) = (c1 + T1 * c2, T1 * T2)

so a depth-sorted splat array cut into contiguous shards composites locally
per lane and then combines ACROSS lanes in shard order.  This holds for
every channel the renderer emits: the premultiplied accumulations (rgb,
depth, alpha, seg) combine under the full transmittance, the vis channels
under their own environment-excluded transmittance, and the amodal
log-transmittances add.

Each shard is composited by a selectable backend into the ``[H, W, 5 + 3K +
2]`` payload, which is exactly the channel layout of the port's tile
compositor (``ops/rasterize_cuda.py``): ``"cuda"`` bins the shard and
launches the compositor kernel once (its plain torch version for CPU
lanes), and so does ``"pallas"``, the reference's name for its kernel
backend; ``"tiled"`` caps the shard's bins at the reference's
``max_per_tile`` default of 1024 entries per tile (``cap_bins``, the
semantics of ``ops/rasterize_tiled.py``) before the same launch;
``"golden"`` runs the per-pixel oracle and packs its outputs.  The
payloads are brought to the first lane's device and combined by
``rasterize_cuda.over`` along a fixed pairwise tree, (0,1)(2,3) then
(01,23) and so on: the tree of the reference's butterfly, so the grouping
of the float32 terms depends on the lane count only and two runs on one
mesh agree bitwise.  The reference's butterfly leaves the result on every
device; here one device combines, since one process drives all lanes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.ops.binning import bin_splats, cap_bins
from pegasus_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import (composite_tiles, num_channels,
                                                   outputs_from_channels, over)
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs, rasterize_projected
from pegasus_tpu_torch.parallel.mesh import Mesh, lane_slices, map_lanes, to_device, tree_map

BACKENDS = ("golden", "cuda", "pallas", "tiled")
TILED_MAX_PER_TILE = 1024  # the reference's "tiled" shards composite at rasterize_projected_tiled's default


def identity_payload(width: int, height: int, k: int, device) -> torch.Tensor:
    """The payload of a shard that composites nothing: every accumulation
    zero, both transmittances one."""
    out = torch.zeros((height, width, num_channels(k)), dtype=torch.float32, device=device)
    out[..., 5 + 3 * k:] = 1.0
    return out


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: the port has 'golden' (the per-pixel oracle), "
            "'cuda' and 'pallas' (the tile compositor kernel) and 'tiled' (the kernel on "
            f"bins capped at {TILED_MAX_PER_TILE} entries per tile)"
        )


def _local_render(backend: str, proj_shard: ProjectedGaussians, width: int, height: int,
                  k: int, chunk: int) -> torch.Tensor:
    """One shard's composite as a [H, W, 5 + 3K + 2] payload."""
    _check_backend(backend)
    dev = proj_shard.mean_x.device
    if proj_shard.mean_x.shape[0] == 0:
        return identity_payload(width, height, k, dev)
    if backend != "golden":
        bins = bin_splats(proj_shard, width, height)
        if backend == "tiled":
            bins = cap_bins(bins, TILED_MAX_PER_TILE)
        return composite_tiles(bins, width, height, k)

    out = rasterize_projected(
        proj_shard, width, height, background=(0.0, 0.0, 0.0), max_objects=k, chunk=chunk
    )
    t_full = (1.0 - out.alpha)[..., None]
    # vis channels need their own transmittance: environment-excluded
    # weights are overlap-free, so their sum = 1 - t_noenv exactly
    t_ne = 1.0 - torch.sum(out.vis_weights, dim=-1, keepdim=True)
    amodal_log = torch.log1p(-torch.clamp(out.amodal, 0.0, 1.0 - 1e-7))
    return torch.cat(
        [out.rgb, out.depth[..., None], out.alpha[..., None], out.seg_weights,
         out.vis_weights, amodal_log, t_full, t_ne],
        dim=-1,
    )


def combine_in_order(payloads: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """Payloads in depth order (nearest first) -> one, by a fixed pairwise
    tree: neighbours combine, then neighbouring pairs, and an odd last
    payload moves up a level as it is."""
    level = list(payloads)
    while len(level) > 1:
        nxt = [over(level[i], level[i + 1], k) for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def _render_on_lanes(cloud: GaussianCloud, cam: Camera, lanes, k: int, chunk: int,
                     backend: str) -> torch.Tensor:
    """Project on the first lane's device, sort by depth, composite one
    contiguous shard per lane, combine there in shard order -> payload."""
    _check_backend(backend)
    first = lanes[0].device
    width, height = cam.width, cam.height
    with torch.no_grad():
        proj = project_gaussians(to_device(cloud, first), to_device(cam, first))
        # global depth order, invalid splats last, ties in splat order (a
        # stable sort): contiguous shards are depth-contiguous, and equal
        # depths on both sides of a boundary keep the unsharded order
        key = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, float("inf")))
        order = torch.argsort(key, stable=True)
        proj = ProjectedGaussians(*(f[order] for f in proj))
        shards = [
            ProjectedGaussians(*(f[cut] for f in proj))
            for cut in lane_slices(proj.mean_x.shape[0], len(lanes))
        ]

        def shard_fn(lane, shard):
            shard = tree_map(lambda t: t.to(lane.device), shard)
            return _local_render(backend, shard, width, height, k, chunk).to(first)

        payloads = map_lanes(lanes, shard_fn, shards)
        return combine_in_order(payloads, k)


def rasterize_splat_sharded(
    cloud: GaussianCloud,
    cam: Camera,
    mesh: Mesh,
    axis: str = "splat",
    background=(0.0, 0.0, 0.0),
    max_objects: int = 8,
    chunk: int = 256,
    backend: str = "cuda",
) -> RenderOutputs:
    """Render with the splat axis sharded over the lanes of ``axis``.

    Splats are depth-sorted globally first, so each shard owns a
    depth-contiguous segment, and the ordered combine reproduces sequential
    compositing up to the grouping of the float32 terms.  The result lies on
    the first lane's device.  ``backend`` is ``"cuda"`` (default: the tile
    compositor, one kernel launch per shard; ``"pallas"`` is the same),
    ``"tiled"`` (the same launch on capped bins) or ``"golden"``; ``chunk``
    is the golden compositor's.

    The reference asks for a splat count that is a multiple of the axis
    size and for a power-of-two axis: the first is ``shard_map``'s equal
    shards, the second its ``ppermute`` butterfly.  Neither holds here:
    shards are cut as ``torch.tensor_split`` cuts them and the combine tree
    carries an odd tail, so any splat count and any lane count are taken.
    """
    if mesh.axis_names != (axis,):
        raise ValueError(f"rasterize_splat_sharded wants a 1-D {axis!r} mesh, got {mesh.axis_names}")
    payload = _render_on_lanes(cloud, cam, mesh.lanes(), max_objects, chunk, backend)
    return outputs_from_channels(payload, background, max_objects)


def rasterize_splat_sharded_batch(
    clouds: Sequence[GaussianCloud],
    cams: Sequence[Camera],
    mesh: Mesh,
    width: int,
    height: int,
    scene_axis: str = "scene",
    splat_axis: str = "splat",
    background=(0.0, 0.0, 0.0),
    max_objects: int = 8,
    chunk: int = 256,
    backend: str = "cuda",
) -> RenderOutputs:
    """HYBRID 2-D sharding: a scene batch data-parallel over ``scene_axis``
    with every scene's splats model-parallel over ``splat_axis``.

    ``clouds`` and ``cams`` are sequences of S scenes and their cameras
    (scenes may differ in splat count); S must be a multiple of the
    scene-axis size.  Row r of the mesh takes the r-th contiguous block of
    scenes and renders each over its own lanes; scene rows never exchange
    anything.  Returns RenderOutputs with a leading scene axis ``[S, ...]``
    on the mesh's first device.
    """
    if mesh.axis_names != (scene_axis, splat_axis):
        raise ValueError(
            f"rasterize_splat_sharded_batch wants a ({scene_axis!r}, {splat_axis!r}) mesh, "
            f"got {mesh.axis_names}"
        )
    n_sc = mesh.shape[scene_axis]
    s = len(clouds)
    if len(cams) != s:
        raise ValueError(f"{s} scenes but {len(cams)} cameras")
    if s % n_sc:
        raise ValueError(f"scene batch ({s}) must divide over {n_sc} shards")
    home = mesh.lanes()[0].device
    outs = []
    for i, (cloud, cam) in enumerate(zip(clouds, cams)):
        if (cam.width, cam.height) != (width, height):
            raise ValueError(f"camera {i} is {cam.width}x{cam.height}, not {width}x{height}")
        row = mesh.lanes((i // (s // n_sc),))
        payload = _render_on_lanes(cloud, cam, row, max_objects, chunk, backend)
        outs.append(outputs_from_channels(payload.to(home), background, max_objects))
    return RenderOutputs(*(torch.stack(field, dim=0) for field in zip(*outs)))
