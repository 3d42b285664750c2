"""Frozen copy of chip_smoke.py's pair_counts, kernel_bound, compositor_bounds and OPS_* constants at commit 7a69f88.

The least time the compositor kernels can take on given bins: operations
over the FP32 peak and bytes over the HBM rate, the larger of the two.
The count walks bins that ``reference.frozen.ops.binning`` made, never the
program's, so a change to the program's binning or kernels moves a kernel's
measured time and never the count it is held against.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA's data sheet, dense): float32 outside the tensor
# cores, and HBM bandwidth
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
# FP32 operations that the least work on these inputs needs, counted from
# the kernels' source.  Per in-image pixel-entry pair, the alpha test
# (entry_alpha: 11 for the quadratic form, 2 min, 1 exp, 1 product, 2 abs and
# 4 compares), which the backward needs only once: S_full = sum_f out[f] gA[f],
# S_ne and the final transmittances are read off the forward's output, so a
# single front-to-back walk gives every entry's gradient.  Per kept pair, the
# forward's compositing (weights, 5 channel sums, 2 transmittances, log1p,
# seg/vis/amodal) and the backward's walk: 1 - alpha, feat.gA (9), the weight
# and prefix (3), dL/dalpha (5), the transmittance, the amodal term (2), rgb
# and depth (4), the clamp test, the chain to mean, conic and opacity (17) and
# the 10 per-entry sums; per kept object pair the vis chain adds 10; per pixel,
# S_full, S_ne and the t_out terms from the forward output.
OPS_ALPHA_TEST = 21
OPS_FWD_KEPT = 19
OPS_BWD_KEPT = 53
OPS_BWD_KEPT_OBJ = 10


def pair_counts(bins, width, height, chunk: int = 128):
    """(in-image pixel-entry pairs, kept pairs, kept pairs of object splats)
    of one frame's or one chunk's bins: the alpha tests and the compositing
    work the kernels must do on these inputs (kept: the kernels' keep rule,
    from the plain versions' walk)."""
    from reference.frozen.ops.binning import P_OBJ
    from reference.frozen.ops.rasterize_cuda import tile_chunks

    pairs = kept = kept_obj = 0
    for c in tile_chunks(bins, chunk):
        inside = ((c.px < width) & (c.py < height))[:, :, None]
        pairs += int((inside & c.ok[:, None, :]).sum())
        kept_in = inside & c.keep
        kept += int(kept_in.sum())
        kept_obj += int((kept_in & (c.p[P_OBJ] != 0)[:, None, :]).sum())
    return pairs, kept, kept_obj


def kernel_bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = ops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compositor_bounds(bins, width, height, k):
    """Bounds of the forward and backward kernels on these bins: each input
    read once, each output written once, the counted operations.  The
    backward's least work reads the forward's output besides the cotangent
    (one walk instead of two, see OPS_BWD_KEPT)."""
    pairs, kept, kept_obj = pair_counts(bins, width, height)
    # entries in segments: all of them, or those cap_bins kept
    n, m, n_tiles = bins.params.shape[1], int(bins.tile_count.sum()), bins.tile_start.numel()
    inputs = 4 * (12 * n + m + 2 * n_tiles)
    pixels = bins.n_frames * height * width
    image = 4 * pixels * (5 + 3 * k + 2)
    per_pixel = pixels * (2 * (5 + k) + 2 * k + 2)
    fwd = kernel_bound(OPS_ALPHA_TEST * pairs + OPS_FWD_KEPT * kept, inputs + image)
    bwd = kernel_bound(OPS_ALPHA_TEST * pairs + OPS_BWD_KEPT * kept + OPS_BWD_KEPT_OBJ * kept_obj
                       + per_pixel, inputs + 2 * image + 4 * 10 * m)
    return {"pairs": pairs, "kept": kept, "kept_obj": kept_obj, "fwd": fwd, "bwd": bwd}


class Bounds:
    """Bounds summed over launches, with which of the two limits bound how
    many of them."""

    def __init__(self):
        self.ms = {"fwd": 0.0, "bwd": 0.0}
        self.by = {"fwd": {}, "bwd": {}}
        self.launches = 0

    def add(self, bins, width, height, k) -> None:
        b = compositor_bounds(bins, width, height, k)
        self.launches += 1
        for key in ("fwd", "bwd"):
            ms, by = b[key]
            self.ms[key] += ms
            self.by[key][by] = self.by[key].get(by, 0) + 1

    def bound_by(self, key: str) -> str:
        return max(self.by[key], key=self.by[key].get) if self.by[key] else "none"
