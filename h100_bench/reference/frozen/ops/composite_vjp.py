"""Frozen copy of pegasus_tpu_torch/ops/composite_vjp.py at commit 7a69f88, without the kernel's launch and the diff wrappers: ``composite_tiles_backward`` runs ``composite_tiles_backward_torch`` on every device; cut to what the benchmark calls.

Differentiable tile compositor: an autograd Function around the CUDA pair.

Replaces ``pegasus_tpu/ops/pallas_vjp.py``.  ``CompositeTiles`` runs the
forward compositor of ``ops/rasterize_cuda.py`` (the sm_90a kernel
``csrc/composite_tiles.cu`` on CUDA tensors, its plain torch version on CPU
tensors) and, as its backward, ``composite_tiles_backward``: the
hand-written sm_90a kernel ``csrc/composite_tiles_bwd.cu`` on CUDA tensors,
its plain torch version ``composite_tiles_backward_torch`` on CPU tensors.
Nothing falls back from one to the other.

Both backward versions compute per-ENTRY gradients ``[10, M]`` of the
parameter rows P_MX .. P_DEPTH (mean x/y, conic a/b/c, opacity, rgb,
depth); a segmented sum then adds each splat's entries in a fixed order
(``sum_by_splat``: the entries grouped by splat with the bins'
``splat_order``, then ``torch.segment_reduce``), where the JAX package left
its gather transpose to XLA (binning.py:103-175).  No float is summed by an
atomic, so a training step is bitwise repeatable on the card.  Rows
P_RADIUS and P_OBJ get zeros.  Everything around the compositor
(projection, binning's ``pack_params``, background blend) differentiates
under torch autograd; the sort order and tile keys are constants, as in
the JAX package and the reference's CUDA backward.

Backward math (pallas_vjp.py:15-35), per pixel and depth-ordered entry e of
its tile, with w_e = a_e T_excl(e) and t_out = prod_e (1 - a_e):

    dL/da_e = T_excl(e) (feat_e . gA) - (S_>e + t_out g_t) / (1 - a_e)
    S_>e    = S - sum_{e' <= e} w_e' (feat_e' . gA),   S = out_A . gA

plus the same terms for the chain with environment alphas zeroed (vis
channels, object entries only) and -gC[obj] / (1 - a_e) for the amodal
log-transmittance, gated by keep & unclamped (no gradient through the 0.99
clamp), then chained to mean, conic and opacity.  One forward-order walk:
the totals S, S_ne and both final transmittances are read off the forward's
output, which ``CompositeTiles`` saves, and each work item of the forward
(``rasterize_cuda.CHUNK_ENTRIES`` entries) starts from the state that the
forward's per-item partials of the items before it give.

``abs_grad_sink`` ([N, 2] zeros that require grad) receives the per-splat
sum of |per-entry mean2d gradient| (AbsGS, the JAX package's
``_gather_rows_structured`` side channel): the entry is a (splat, tile)
pair, so this is the tile-granular |grad| statistic.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from reference.frozen.ops import binning as B
from reference.frozen.ops.binning import TileBins
from reference.frozen.ops.rasterize_cuda import (CHUNK_ENTRIES, _check_bins, composite_tiles,
                                                   num_channels, partials_shape,
                                                   tile_chunks, tile_items)

N_GRAD = 10  # gradient rows P_MX .. P_DEPTH


def _check_grad(bins: TileBins, grad_out: torch.Tensor, out, partials, width: int, height: int,
                max_objects: int, chunk_entries: int) -> None:
    want = (height, width, num_channels(max_objects))
    if bins.n_frames != 1:
        raise ValueError(f"the backward composites one frame; the bins hold {bins.n_frames}")
    if out is None or partials is None:
        raise ValueError(
            "composite_tiles_backward needs the forward's output and per-item partials "
            "(composite_tiles(..., return_partials=True))"
        )
    expect = {"grad_out": (grad_out, want), "out": (out, want),
              "partials": (partials, partials_shape(bins, max_objects, chunk_entries))}
    for name, (t, shape) in expect.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != bins.params.device:
            raise ValueError(f"{name} on {t.device}, params on {bins.params.device}")


def composite_tiles_backward(
    bins: TileBins, grad_out: torch.Tensor, out: torch.Tensor, partials: torch.Tensor,
    width: int, height: int, max_objects: int, chunk_entries: int = CHUNK_ENTRIES,
) -> torch.Tensor:
    """Per-entry gradients [10, M] (rows P_MX .. P_DEPTH) from the cotangent
    ``grad_out`` [H, W, 5 + 3K + 2] of ``composite_tiles``' output ``out``,
    given that call's per-item ``partials`` (``return_partials=True``, the
    same ``chunk_entries``).  Raises when either is missing.  The columns of
    entries in no segment (those ``cap_bins`` dropped) are not written, and
    ``sum_by_splat`` reads none of them.

    Every device runs ``composite_tiles_backward_torch`` (this copy holds no
    kernel)."""
    _check_bins(bins, width, height, max_objects)
    _check_grad(bins, grad_out, out, partials, width, height, max_objects, chunk_entries)
    return composite_tiles_backward_torch(bins, grad_out, out, partials, width, height,
                                          max_objects, chunk_entries=chunk_entries)


def _per_tile(img: torch.Tensor, bins: TileBins) -> torch.Tensor:
    """[H, W, F] -> [n_tiles, PX, F], zero past the ragged edge."""
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    h, w, f = img.shape
    t = torch.zeros(nty * B.TILE, ntx * B.TILE, f, device=img.device)
    t[:h, :w] = img
    return t.reshape(nty, B.TILE, ntx, B.TILE, f).permute(0, 2, 1, 3, 4).reshape(ntx * nty, -1, f)


def composite_tiles_backward_torch(
    bins: TileBins, grad_out: torch.Tensor, out: torch.Tensor, partials: torch.Tensor,
    width: int, height: int, max_objects: int, chunk: int = 64,
    chunk_entries: int = CHUNK_ENTRIES,
) -> torch.Tensor:
    """Plain torch version of the backward kernel, same inputs and [10, M]
    output.  Vectorised over tiles in chunks of entries, like
    ``composite_tiles_torch``, in one walk: the totals come from ``out``,
    and each work item starts from the state the partials of the items
    before it give."""
    _check_bins(bins, width, height, max_objects)
    _check_grad(bins, grad_out, out, partials, width, height, max_objects, chunk_entries)
    dev = bins.params.device
    k = max_objects
    n_tiles = bins.n_tiles_x * bins.n_tiles_y
    px_n = B.TILE * B.TILE

    # cotangent and forward output per tile [n_tiles, PX, F]; pixels past
    # the ragged edge have zero cotangent
    g, o = _per_tile(grad_out, bins), _per_tile(out, bins)
    g_a, g_b, g_c = g[..., : 5 + k], g[..., 5 + k : 5 + 2 * k], g[..., 5 + 2 * k : 5 + 3 * k]
    g_tf, g_tn = g[..., 5 + 3 * k], g[..., 5 + 3 * k + 1]
    s_full = (o[..., : 5 + k] * g_a).sum(-1)
    s_ne = (o[..., 5 + k : 5 + 2 * k] * g_b).sum(-1)
    t_full_end, t_ne_end = o[..., 5 + 3 * k], o[..., 5 + 3 * k + 1]

    kk = torch.arange(k, device=dev)

    def excl_and_total(a_c):
        keep_frac = torch.cumprod(1.0 - a_c, dim=-1)
        excl = torch.cat([torch.ones_like(keep_frac[..., :1]), keep_frac[..., :-1]], -1)
        return excl, keep_frac[..., -1]

    # the running state (transmittances, prefix sums) and the start state
    # of the current item, carried over the items' partials
    _, first = tile_items(bins, chunk_entries)
    t_full, t_ne = torch.ones(n_tiles, px_n, device=dev), torch.ones(n_tiles, px_n, device=dev)
    r_full, r_ne = torch.zeros(n_tiles, px_n, device=dev), torch.zeros(n_tiles, px_n, device=dev)
    start = [t.clone() for t in (t_full, t_ne, r_full, r_ne)]
    item = 0
    entry_grad = torch.zeros(N_GRAD, bins.entry_splat.numel(), device=dev)
    for t_c in tile_chunks(bins, chunk, chunk_entries):
        act = t_c.act
        if t_c.lo // chunk_entries > item:  # the next item: fold in the one before
            item = t_c.lo // chunk_entries
            part = partials[first[act] + item - 1].transpose(1, 2)  # [A, PX, F]
            t0, t0_ne, p0, p0_ne = start
            p0[act] += t0[act] * (part[..., : 5 + k] * g_a[act]).sum(-1)
            p0_ne[act] += t0_ne[act] * (part[..., 5 + k : 5 + 2 * k] * g_b[act]).sum(-1)
            t0[act] *= part[..., 5 + 3 * k]
            t0_ne[act] *= part[..., 5 + 3 * k + 1]
            for run, st in zip((t_full, t_ne, r_full, r_ne), start):
                run[act] = st[act]

        a = torch.where(t_c.keep, t_c.alpha, torch.zeros_like(t_c.alpha))
        obj = t_c.p[B.P_OBJ].long()  # [A, C]
        env = (obj == 0)[:, None, :]
        onehot = (obj[..., None] == kk).to(torch.float32)  # [A, C, K]
        feat = torch.cat(
            [t_c.p[[B.P_R, B.P_G, B.P_B, B.P_DEPTH]].permute(1, 2, 0),
             torch.ones_like(onehot[..., :1]), onehot],
            dim=-1,
        )  # [A, C, 5 + K]
        fg = torch.bmm(g_a[act], feat.transpose(1, 2))  # feat . gA: [A, PX, C]
        fg_ne = torch.bmm(g_b[act], onehot.transpose(1, 2))
        a_ne = torch.where(env, torch.zeros_like(a), a)

        da = torch.zeros_like(a)
        w_full = None
        for a_c, f_c, t, r, s, t_end, g_t, mask in (
            (a, fg, t_full, r_full, s_full, t_full_end, g_tf, None),
            (a_ne, fg_ne, t_ne, r_ne, s_ne, t_ne_end, g_tn, env),
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
        da = da - torch.bmm(g_c[act], onehot.transpose(1, 2)) / (1.0 - a)
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


def sum_by_splat(bins: TileBins, rows: torch.Tensor) -> torch.Tensor:
    """[R, M] per-entry rows -> [R, N] per-splat sums, each splat's entries
    added in entry order by one segmented sum (no atomics: the same bits
    every run), with the bins' ``splat_order`` / ``splat_count``.  Rows of
    entries in no segment (dropped by ``cap_bins``) come last in
    ``splat_order`` and are not summed; ``unsafe`` skips the check that the
    counts add up to M, which would also read two values back to the host."""
    grouped = rows.T[bins.splat_order]  # [M, R], grouped by splat
    return torch.segment_reduce(grouped, "sum", lengths=bins.splat_count, axis=0, unsafe=True).T


def entry_grads_to_splats(bins: TileBins, entry_grad: torch.Tensor) -> torch.Tensor:
    """[10, M] per-entry gradients -> [PARAM_DIM, N] per-splat gradients
    (rows P_RADIUS and P_OBJ zero)."""
    dparams = torch.zeros_like(bins.params)
    dparams[:N_GRAD] = sum_by_splat(bins, entry_grad)
    return dparams


class CompositeTiles(torch.autograd.Function):
    """``composite_tiles`` with ``composite_tiles_backward`` as its gradient.

    apply(params, abs_grad_sink, entry_splat, tile_start, tile_count, splat_order,
    splat_count, n_tiles_x, n_tiles_y, max_object_id, width, height,
    max_objects) -> [H, W, F]; the gradient reaches ``params`` and, when
    given, ``abs_grad_sink``.  The
    output and the per-item partials are saved for the backward's one walk;
    autograd's version check raises if anything edits the output in place."""

    @staticmethod
    def forward(ctx, params, abs_grad_sink, entry_splat, tile_start, tile_count, splat_order,
                splat_count, n_tiles_x, n_tiles_y, max_object_id, width, height, max_objects):
        bins = TileBins(params, entry_splat, tile_start, tile_count, n_tiles_x, n_tiles_y,
                        max_object_id, splat_order, splat_count)
        out, partials = composite_tiles(bins, width, height, max_objects, return_partials=True)
        ctx.save_for_backward(params, entry_splat, tile_start, tile_count, splat_order,
                              splat_count, out, partials)
        ctx.meta = (n_tiles_x, n_tiles_y, max_object_id, width, height, max_objects)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (params, entry_splat, tile_start, tile_count, splat_order, splat_count, out,
         partials) = ctx.saved_tensors
        ntx, nty, max_id, width, height, k = ctx.meta
        bins = TileBins(params, entry_splat, tile_start, tile_count, ntx, nty, max_id,
                        splat_order, splat_count)
        entry_grad = composite_tiles_backward(bins, grad_out, out, partials, width, height, k)
        dparams = entry_grads_to_splats(bins, entry_grad)
        dsink = None
        if ctx.needs_input_grad[1]:
            dsink = sum_by_splat(bins, entry_grad[0:2].abs()).T
        return (dparams, dsink) + (None,) * 11


def composite_tiles_diff(
    bins: TileBins, width: int, height: int, max_objects: int, abs_grad_sink=None
) -> torch.Tensor:
    """Differentiable ``composite_tiles``: [H, W, F] with gradients to
    ``bins.params`` (and ``abs_grad_sink``).  Bins capped by ``cap_bins``
    go through as they are: the forward, its saved partials, K3 and the sum
    to splats all see the same kept entries."""
    return CompositeTiles.apply(
        bins.params, abs_grad_sink, bins.entry_splat, bins.tile_start, bins.tile_count,
        bins.splat_order, bins.splat_count, bins.n_tiles_x, bins.n_tiles_y, bins.max_object_id,
        width, height, max_objects,
    )


