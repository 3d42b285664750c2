"""Frozen copy of pegasus_tpu_torch/utils/sh.py at commit 7a69f88, cut to what the benchmark calls.

Real spherical harmonics in the Inria-3DGS basis, plus SH band rotation.

Port of ``pegasus_tpu/utils/sh.py``.  The band rotation matrix is recovered
exactly from basis evaluations at a fixed direction set:

    Y_i(R d) = sum_j D[i, j] Y_j(d)   =>   D^T = pinv(Y(dirs)) @ Y(dirs @ R^T)

The direction set and its pseudo-inverses are numpy constants built at
import (no device work); they are moved to the rotation's device per call.
"""

from __future__ import annotations

import numpy as np
import torch

# Inria sh_utils constants
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def rgb2sh(rgb):
    """RGB in [0,1] -> DC SH coefficient (Inria utils.sh_utils.RGB2SH)."""
    return (rgb - 0.5) / C0


def sh2rgb(sh):
    """DC SH coefficient -> RGB (Inria utils.sh_utils.SH2RGB)."""
    return sh * C0 + 0.5


def _basis_band1(d, xp=torch):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return xp.stack([-C1 * y, C1 * z, -C1 * x], -1)


def _basis_band2(d, xp=torch):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return xp.stack(
        [
            C2[0] * x * y,
            C2[1] * y * z,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * x * z,
            C2[4] * (xx - yy),
        ],
        -1,
    )


def _basis_band3(d, xp=torch):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return xp.stack(
        [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * x * y * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ],
        -1,
    )


_BAND_FNS = {1: _basis_band1, 2: _basis_band2, 3: _basis_band3}
_BAND_DIMS = {1: 3, 2: 5, 3: 7}


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH radiance; matches Inria ``eval_sh``.

    sh: [..., (deg+1)^2, C] coefficients (DC first); dirs: [..., 3] unit
    directions from the camera center to the splat.  Returns [..., C] raw
    radiance (the caller adds +0.5 and clamps, as the CUDA rasterizer does).
    """
    result = C0 * sh[..., 0, :]
    if deg >= 1:
        b1 = _basis_band1(dirs)
        for i in range(3):
            result = result + b1[..., i : i + 1] * sh[..., 1 + i, :]
    if deg >= 2:
        b2 = _basis_band2(dirs)
        for i in range(5):
            result = result + b2[..., i : i + 1] * sh[..., 4 + i, :]
    if deg >= 3:
        b3 = _basis_band3(dirs)
        for i in range(7):
            result = result + b3[..., i : i + 1] * sh[..., 9 + i, :]
    return result


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        -1,
    )


_SAMPLE_DIRS = _fibonacci_sphere(32).astype(np.float32)
_PINV = {
    band: np.linalg.pinv(fn(_SAMPLE_DIRS, xp=np).astype(np.float64)).astype(np.float32)
    for band, fn in _BAND_FNS.items()
}


_CONSTANTS: dict = {}  # (band, dtype, device) -> (sample directions, pinv) on the device


def _band_constants(band: int, dtype, device):
    """The sample directions and the band's pseudo-inverse on ``device``,
    copied there once (a copy from host memory waits for the device)."""
    key = (band, dtype, device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = (torch.as_tensor(_SAMPLE_DIRS, dtype=dtype, device=device),
                           torch.as_tensor(_PINV[band], dtype=dtype, device=device))
    return _CONSTANTS[key]


def sh_band_rotation(R: torch.Tensor, band: int) -> torch.Tensor:
    """Exact rotation matrix D_band for the real-SH band under rotation R.

    Y_i(R d) = sum_j D[i,j] Y_j(d); rotating an object by R maps its band
    coefficients c -> D c.  Batched over leading dims of R.
    """
    dirs, pinv = _band_constants(band, R.dtype, R.device)
    rotated = torch.einsum("...ij,kj->...ki", R, dirs)
    B1 = _BAND_FNS[band](rotated)  # [..., 32, 2l+1]: B1[k, i] = Y_i(R d_k)
    Dt = torch.einsum("jk,...ki->...ji", pinv, B1)
    return Dt.transpose(-1, -2)


