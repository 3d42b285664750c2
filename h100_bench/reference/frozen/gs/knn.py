"""Frozen copy of pegasus_tpu_torch/gs/knn.py at commit 7a69f88.

k-nearest-neighbour distances in blocked torch.

Port of ``pegasus_tpu/gs/knn.py``, the replacement for the reference's
``simple-knn`` CUDA extension (``distCUDA2``: mean squared distance to the 3
nearest neighbours, used to initialise splat scales; reference:
src/gs/gaussian_model.py:25,144-149).  Blocked pairwise distances keep
memory at O(N * block) through the |a-b|^2 = |a|^2 + |b|^2 - 2ab expansion;
the product is a plain float32 ``torch.matmul``.  On the card that product
is full float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default; the JAX package asks for ``Precision.HIGHEST``):
``mean_knn_dist2`` checks the flag and never sets it.
"""

from __future__ import annotations

import torch


def mean_knn_dist2(points: torch.Tensor, k: int = 3, block: int = 2048) -> torch.Tensor:
    """[N] mean SQUARED distance to each point's k nearest neighbours
    (distCUDA2 semantics: the k smallest d^2 to other points; self is
    excluded by index, so duplicates count at distance 0)."""
    if points.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the distance "
            "product would round to TF32 (set it back to False)"
        )
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    rows = torch.arange(n, device=pts.device)
    best = torch.full((n, k), float("inf"), device=pts.device)
    for lo in range(0, n, block):
        blk = pts[lo : lo + block]
        d2 = sq[:, None] + sq[None, lo : lo + block] - 2.0 * torch.matmul(pts, blk.T)
        d2 = torch.clamp(d2, min=0.0)
        cols = lo + torch.arange(blk.shape[0], device=pts.device)
        d2 = torch.where(rows[:, None] == cols[None, :], float("inf"), d2)
        merged = torch.cat([best, d2], dim=1)
        best = -torch.topk(-merged, k, dim=1).values
    return torch.mean(best, dim=1)
