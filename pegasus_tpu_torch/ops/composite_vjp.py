"""Differentiable tile compositor: an autograd Function around the CUDA pair.

Replaces ``pegasus_tpu/ops/pallas_vjp.py``.  ``CompositeTiles`` runs the
forward compositor of ``ops/rasterize_cuda.py`` (the sm_90a kernel
``csrc/composite_tiles.cu`` on CUDA tensors, its plain torch version on CPU
tensors) and, as its backward, ``composite_tiles_backward``: the
hand-written sm_90a kernel ``csrc/composite_tiles_bwd.cu`` on CUDA tensors,
its plain torch version ``composite_tiles_backward_torch`` on CPU tensors.
Nothing falls back from one to the other.

Both backward versions compute per-ENTRY gradients ``[10, M]`` of the
parameter rows P_MX .. P_DEPTH (mean x/y, conic a/b/c, opacity, rgb,
depth); ``index_add_`` then scatters them to the splats, where the JAX
package left its gather transpose to XLA (binning.py:103-175).  Rows
P_RADIUS and P_OBJ get zeros.  Everything around the compositor
(projection, binning's ``pack_params``, background blend) differentiates
under torch autograd; the sort order and tile keys are constants, as in
the JAX package and the reference's CUDA backward.

Backward math (pallas_vjp.py:15-35), per pixel and depth-ordered entry e of
its tile, with w_e = a_e T_excl(e) and t_out = prod_e (1 - a_e):

    dL/da_e = T_excl(e) (feat_e . gA) - (S_>e + t_out g_t) / (1 - a_e)
    S_>e    = sum_{e' > e} w_e' (feat_e' . gA)

plus the same terms for the chain with environment alphas zeroed (vis
channels, object entries only) and -gC[obj] / (1 - a_e) for the amodal
log-transmittance, gated by keep & unclamped (no gradient through the 0.99
clamp), then chained to mean, conic and opacity.  Two forward-order passes:
pass 1 gives the totals S and the final transmittances, pass 2 forms
S_>e = S - prefix.

``abs_grad_sink`` ([N, 2] zeros that require grad) receives the per-splat
sum of |per-entry mean2d gradient| (AbsGS, the JAX package's
``_gather_rows_structured`` side channel): the entry is a (splat, tile)
pair, so this is the tile-granular |grad| statistic.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.ops import binning as B
from pegasus_tpu_torch.ops.binning import TileBins, bin_splats
from pegasus_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import (_check_bins, composite_tiles,
                                                   kernel_lib, num_channels,
                                                   outputs_from_channels, tile_chunks)
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs

N_GRAD = 10  # gradient rows P_MX .. P_DEPTH


def _bwd_lib():
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return kernel_lib("composite_tiles_bwd.cu", "composite_tiles_bwd_launch",
                      [p, i64, p, p, p, p, p, i64, i32, i32, i32, i32, i32, p])


def _check_grad(bins: TileBins, grad_out: torch.Tensor, width: int, height: int,
                max_objects: int) -> None:
    want = (height, width, num_channels(max_objects))
    if grad_out.dtype != torch.float32 or tuple(grad_out.shape) != want:
        raise ValueError(
            f"grad_out: want float32 {want}, got {grad_out.dtype} {tuple(grad_out.shape)}"
        )
    if grad_out.device != bins.params.device:
        raise ValueError(f"grad_out on {grad_out.device}, params on {bins.params.device}")


def composite_tiles_backward(
    bins: TileBins, grad_out: torch.Tensor, width: int, height: int, max_objects: int
) -> torch.Tensor:
    """Per-entry gradients [10, M] (rows P_MX .. P_DEPTH) from the cotangent
    ``grad_out`` [H, W, 5 + 3K + 2] of ``composite_tiles``' output.

    CPU tensors run ``composite_tiles_backward_torch``; CUDA tensors launch
    the kernel on the current stream (built at first use) or raise."""
    _check_bins(bins, width, height, max_objects)
    _check_grad(bins, grad_out, width, height, max_objects)
    if bins.params.device.type == "cpu":
        return composite_tiles_backward_torch(bins, grad_out, width, height, max_objects)
    if bins.params.device.type != "cuda":
        raise ValueError(f"composite_tiles_backward: unsupported device {bins.params.device}")
    dev = bins.params.device
    grad_out = grad_out.contiguous()  # slices of the outputs arrive strided
    n_entries = bins.entry_splat.numel()
    entry_grad = torch.empty((N_GRAD, n_entries), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        err = lib.composite_tiles_bwd_launch(
            bins.params.data_ptr(), bins.params.shape[1],
            bins.entry_splat.data_ptr(), bins.tile_start.data_ptr(),
            bins.tile_count.data_ptr(), grad_out.data_ptr(),
            entry_grad.data_ptr(), n_entries,
            width, height, bins.n_tiles_x, bins.n_tiles_y, max_objects,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_tiles_backward kernel launch failed: CUDA error {err}")
    composite_tiles_backward.launches += 1
    return entry_grad


composite_tiles_backward.launches = 0


def composite_tiles_backward_torch(
    bins: TileBins, grad_out: torch.Tensor, width: int, height: int, max_objects: int,
    chunk: int = 64,
) -> torch.Tensor:
    """Plain torch version of the backward kernel, same inputs and [10, M]
    output.  Vectorised over tiles in chunks of entries, like
    ``composite_tiles_torch``: pass 1 accumulates the totals and the final
    transmittances chunk by chunk, pass 2 walks again with prefix sums."""
    _check_bins(bins, width, height, max_objects)
    _check_grad(bins, grad_out, width, height, max_objects)
    dev = bins.params.device
    k = max_objects
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    n_tiles = ntx * nty
    px_n = B.TILE * B.TILE

    # cotangent per tile [n_tiles, PX, F]; pixels past the ragged edge are 0
    g = torch.zeros(nty * B.TILE, ntx * B.TILE, num_channels(k), device=dev)
    g[:height, :width] = grad_out
    g = g.reshape(nty, B.TILE, ntx, B.TILE, -1).permute(0, 2, 1, 3, 4).reshape(n_tiles, px_n, -1)
    g_a, g_b, g_c = g[..., : 5 + k], g[..., 5 + k : 5 + 2 * k], g[..., 5 + 2 * k : 5 + 3 * k]
    g_tf, g_tn = g[..., 5 + 3 * k], g[..., 5 + 3 * k + 1]

    kk = torch.arange(k, device=dev)

    def chunks():
        """Per step of ``tile_chunks``: the forward's alphas and the
        features' dot products with the cotangent."""
        for c in tile_chunks(bins, chunk):
            a = torch.where(c.keep, c.alpha, torch.zeros_like(c.alpha))
            obj = c.p[B.P_OBJ].long()  # [A, C]
            env = (obj == 0)[:, None, :]
            onehot = (obj[..., None] == kk).to(torch.float32)  # [A, C, K]
            feat = torch.cat(
                [c.p[[B.P_R, B.P_G, B.P_B, B.P_DEPTH]].permute(1, 2, 0),
                 torch.ones_like(onehot[..., :1]), onehot],
                dim=-1,
            )  # [A, C, 5 + K]
            fg = torch.bmm(g_a[c.act], feat.transpose(1, 2))  # feat . gA: [A, PX, C]
            fg_ne = torch.bmm(g_b[c.act], onehot.transpose(1, 2))
            yield c, dict(a=a, a_ne=torch.where(env, torch.zeros_like(a), a), env=env,
                          onehot=onehot, fg=fg, fg_ne=fg_ne)

    def excl_and_total(a_c):
        keep_frac = torch.cumprod(1.0 - a_c, dim=-1)
        excl = torch.cat([torch.ones_like(keep_frac[..., :1]), keep_frac[..., :-1]], -1)
        return excl, keep_frac[..., -1]

    # ---- pass 1: totals S, S_ne and the final transmittances ----------------
    t_full = torch.ones(n_tiles, px_n, device=dev)
    t_ne = torch.ones(n_tiles, px_n, device=dev)
    s_full = torch.zeros(n_tiles, px_n, device=dev)
    s_ne = torch.zeros(n_tiles, px_n, device=dev)
    for t_c, c in chunks():
        act = t_c.act
        for a_c, f_c, t, s in ((c["a"], c["fg"], t_full, s_full),
                               (c["a_ne"], c["fg_ne"], t_ne, s_ne)):
            excl, frac = excl_and_total(a_c)
            s[act] += (a_c * excl * t[act][:, :, None] * f_c).sum(-1)
            t[act] = t[act] * frac
    t_full_end, t_ne_end = t_full, t_ne

    # ---- pass 2: per-entry gradients ------------------------------------------
    entry_grad = torch.zeros(N_GRAD, bins.entry_splat.numel(), device=dev)
    t_full = torch.ones(n_tiles, px_n, device=dev)
    t_ne = torch.ones(n_tiles, px_n, device=dev)
    r_full = torch.zeros(n_tiles, px_n, device=dev)
    r_ne = torch.zeros(n_tiles, px_n, device=dev)
    for t_c, c in chunks():
        act, a = t_c.act, c["a"]
        da = torch.zeros_like(a)
        w_full = None
        for a_c, f_c, t, r, s, t_end, g_t, mask in (
            (a, c["fg"], t_full, r_full, s_full, t_full_end, g_tf, None),
            (c["a_ne"], c["fg_ne"], t_ne, r_ne, s_ne, t_ne_end, g_tn, c["env"]),
        ):
            excl, frac = excl_and_total(a_c)
            t_excl = excl * t[act][:, :, None]
            w = a_c * t_excl
            contrib = w * f_c
            suffix = s[act][:, :, None] - (torch.cumsum(contrib, -1) + r[act][:, :, None])
            d = t_excl * f_c - (suffix + (t_end[act] * g_t[act])[:, :, None]) / (1.0 - a_c)
            da = da + (d if mask is None else torch.where(mask, torch.zeros_like(d), d))
            r[act] += contrib.sum(-1)
            t[act] = t[act] * frac
            if w_full is None:
                w_full = w
        # amodal: d log(1 - a) / da for every kept entry, environment included
        da = da - torch.bmm(g_c[act], c["onehot"].transpose(1, 2)) / (1.0 - a)
        da = da * (t_c.keep & (t_c.raw < 0.99)).to(torch.float32)
        dpow = da * a  # d raw / d power = raw = alpha when unclamped
        dx, dy = t_c.dx, t_c.dy
        ca, cb, cc = (t_c.p[r][:, None, :] for r in (B.P_CA, B.P_CB, B.P_CC))
        rows = [
            (dpow * (ca * dx + cb * dy)).sum(1),
            (dpow * (cc * dy + cb * dx)).sum(1),
            (dpow * (-0.5 * dx * dx)).sum(1),
            (dpow * (-dx * dy)).sum(1),
            (dpow * (-0.5 * dy * dy)).sum(1),
            (da * t_c.exppow).sum(1),
        ]  # each [A, C]
        rgbd = torch.bmm(w_full.transpose(1, 2), g_a[act][..., 0:4])  # [A, C, 4]
        vals = torch.cat([torch.stack(rows, 0), rgbd.permute(2, 0, 1)], 0)  # [10, A, C]
        entry_grad[:, t_c.idx[t_c.ok]] = vals[:, t_c.ok]
    return entry_grad


def entry_grads_to_splats(bins: TileBins, entry_grad: torch.Tensor) -> torch.Tensor:
    """[10, M] per-entry gradients -> [PARAM_DIM, N] per-splat gradients
    (rows P_RADIUS and P_OBJ zero)."""
    dparams = torch.zeros_like(bins.params)
    dparams[:N_GRAD].index_add_(1, bins.entry_splat.long(), entry_grad)
    return dparams


class CompositeTiles(torch.autograd.Function):
    """``composite_tiles`` with ``composite_tiles_backward`` as its gradient.

    apply(params, abs_grad_sink, entry_splat, tile_start, tile_count, n_tiles_x,
    n_tiles_y, max_object_id, width, height, max_objects) -> [H, W, F]; the
    gradient reaches ``params`` and, when given, ``abs_grad_sink``."""

    @staticmethod
    def forward(ctx, params, abs_grad_sink, entry_splat, tile_start, tile_count,
                n_tiles_x, n_tiles_y, max_object_id, width, height, max_objects):
        bins = TileBins(params, entry_splat, tile_start, tile_count,
                        n_tiles_x, n_tiles_y, max_object_id)
        ctx.save_for_backward(params, entry_splat, tile_start, tile_count)
        ctx.meta = (n_tiles_x, n_tiles_y, max_object_id, width, height, max_objects)
        return composite_tiles(bins, width, height, max_objects)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        params, entry_splat, tile_start, tile_count = ctx.saved_tensors
        ntx, nty, max_id, width, height, k = ctx.meta
        bins = TileBins(params, entry_splat, tile_start, tile_count, ntx, nty, max_id)
        entry_grad = composite_tiles_backward(bins, grad_out, width, height, k)
        dparams = entry_grads_to_splats(bins, entry_grad)
        dsink = None
        if ctx.needs_input_grad[1]:
            dsink = torch.zeros(params.shape[1], 2, device=params.device)
            dsink.index_add_(0, entry_splat.long(), entry_grad[0:2].abs().T)
        return dparams, dsink, None, None, None, None, None, None, None, None, None


def composite_tiles_diff(
    bins: TileBins, width: int, height: int, max_objects: int, abs_grad_sink=None
) -> torch.Tensor:
    """Differentiable ``composite_tiles``: [H, W, F] with gradients to
    ``bins.params`` (and ``abs_grad_sink``)."""
    return CompositeTiles.apply(
        bins.params, abs_grad_sink, bins.entry_splat, bins.tile_start, bins.tile_count,
        bins.n_tiles_x, bins.n_tiles_y, bins.max_object_id, width, height, max_objects,
    )


def rasterize_projected_diff(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    background=(0.0, 0.0, 0.0),
    max_objects: int = 8,
    abs_grad_sink=None,
) -> RenderOutputs:
    """Differentiable rasterizer of projected splats (counterpart of
    ``rasterize_projected_pallas``, pallas_vjp.py:499): exact binning, then
    the compositor pair."""
    bins = bin_splats(proj, width, height)
    out = composite_tiles_diff(bins, width, height, max_objects, abs_grad_sink)
    return outputs_from_channels(out, background, max_objects)


def rasterize_diff(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
) -> RenderOutputs:
    """Differentiable ``rasterize`` (counterpart of ``rasterize_pallas_diff``,
    pallas_vjp.py:538)."""
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    return rasterize_projected_diff(proj, cam.width, cam.height, background, max_objects)
