"""Frozen copy of pegasus_tpu_torch/training/losses.py at commit 7a69f88.

Training losses: L1 + D-SSIM, the Inria 3DGS objective.

Port of ``pegasus_tpu/training/losses.py``.  The reference trains its
assets through the gaussian-splatting submodule's ``train.training``
(reference: src/gs/gs_training.py:46-47), whose loss is
(1 - lambda) * L1 + lambda * (1 - SSIM), lambda = 0.2.

The separable 11-tap Gaussian blur is a sum of 11 shifted slices of a
zero-padded tensor, one pass per axis, in plain float32 elementwise
arithmetic.  It is not a ``conv2d``: cuDNN runs float32 convolutions in
TF32 by default (``torch.backends.cudnn.allow_tf32``), about three decimal
digits, where the JAX package asks for ``Precision.HIGHEST``
(losses.py:52-54), and a library does not flip a global flag.
"""

from __future__ import annotations

import torch


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> list[float]:
    """The normalised taps, computed in float32 as the JAX package does."""
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).tolist()


def _blur(x: torch.Tensor, taps: list[float]) -> torch.Tensor:
    """Separable 'SAME' zero-padded blur of [H, W, C] along H, then W."""
    h, w = x.shape[0], x.shape[1]
    r = len(taps) // 2
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, r, r))  # rows
    x = sum(t * xp[i : i + h] for i, t in enumerate(taps))
    xp = torch.nn.functional.pad(x, (0, 0, r, r))  # columns
    return sum(t * xp[:, i : i + w] for i, t in enumerate(taps))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair in [0, 1]."""
    c1 = 0.01**2
    c2 = 0.03**2
    taps = _gaussian_1d(window_size)
    mu1 = _blur(img1, taps)
    mu2 = _blur(img2, taps)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, taps) - mu1_sq
    sigma2_sq = _blur(img2 * img2, taps) - mu2_sq
    sigma12 = _blur(img1 * img2, taps) - mu12
    s = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(s)


def gs_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    l1 = torch.mean(torch.abs(pred - gt))
    s = ssim(pred, gt)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - s), {"l1": l1, "ssim": s}

