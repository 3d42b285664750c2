"""Per-tile-budget rasterizer: exact binning capped at ``max_per_tile``.

Port of ``pegasus_tpu/ops/rasterize_tiled.py``, the JAX package's second
renderer (its default off TPU, and ``GSTrainer``'s ``backend="tiled"``).
Its observable semantics are what is ported: each tile keeps the first
``max_per_tile`` entries of its depth-ordered segment, and every later
entry contributes nothing.  The reference gets there by padding every
segment to a static budget and scanning dense [n_tiles, px, chunk] blocks
(rasterize_tiled.py:56-139), a shape device for XLA; here ``cap_bins``
drops the entries past the budget from exact bins, and the tile compositor
of ``ops/rasterize_cuda.py`` composites what is left: the forward kernel
(K1, ``csrc/composite_tiles.cu``) on the card, its plain torch version on
the CPU.  Under autograd the same bins go through ``CompositeTiles`` (the
forward kernel and K3), as ``GSTrainer(backend="tiled")`` trains.

The TPU knobs ``chunk``, ``a_small``, ``big_budget``, ``a_big`` and
``dup_factor`` are accepted and read by nothing: exact binning has no
buckets and the kernel no scan chunk.  ``tile`` must be the kernel's 16.
An object id >= ``max_objects`` raises, as in ``rasterize``, where the
reference clips it into the last channel.
"""

from __future__ import annotations

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.ops.binning import TILE, TileBins, bin_splats, cap_bins
from pegasus_tpu_torch.ops.composite_vjp import composite_tiles_diff
from pegasus_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import outputs_from_channels
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs


def composite_tiles_xla(
    bins: TileBins,
    width: int,
    height: int,
    background,
    max_objects: int = 8,
    max_per_tile: int = 1024,
    chunk: int = 256,
) -> RenderOutputs:
    """Composite ``cap_bins(bins, max_per_tile)`` of one frame ->
    RenderOutputs (``chunk`` is not read): one forward launch, and
    differentiable in ``bins.params`` through the compositor pair."""
    out = composite_tiles_diff(cap_bins(bins, max_per_tile), width, height, max_objects)
    return outputs_from_channels(out, background, max_objects)


def _check_tile(tile: int) -> None:
    if tile != TILE:
        raise ValueError(f"tile={tile}: the compositor kernels work on {TILE}x{TILE} tiles")


def rasterize_projected_tiled(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    background,
    max_objects: int = 8,
    tile: int = 16,
    max_per_tile: int = 1024,
    chunk: int = 256,
    a_small: int = 4,
    big_budget: int = 16384,
    a_big: int = 36,
) -> RenderOutputs:
    """Projected splats -> exact bins -> ``composite_tiles_xla`` (the
    binning knobs are not read)."""
    _check_tile(tile)
    return composite_tiles_xla(bin_splats(proj, width, height), width, height, background,
                               max_objects=max_objects, max_per_tile=max_per_tile)


def rasterize_tiled(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
    tile: int = 16,
    max_per_tile: int = 1024,
    chunk: int = 256,
    a_small: int = 4,
    big_budget: int = 16384,
    a_big: int = 36,
    dup_factor: int = 0,
) -> RenderOutputs:
    """Drop-in alternative to ``rasterize`` (same RenderOutputs) that
    composites at most ``max_per_tile`` entries per tile; with a cap at or
    above the longest segment it has ``rasterize``'s bits."""
    _check_tile(tile)
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    return rasterize_projected_tiled(proj, cam.width, cam.height, background,
                                     max_objects=max_objects, max_per_tile=max_per_tile)
