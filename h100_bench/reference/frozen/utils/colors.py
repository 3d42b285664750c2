"""Frozen copy of pegasus_tpu_torch/utils/colors.py at commit 7a69f88.

Copied verbatim from ``pegasus_tpu/utils/colors.py``; only the import lines differ.

Semantic color assignment for segmentation rendering.

Reproduces the reference's evenly-spaced HLS palette
(reference: src/utility/graphic_utils.py:40-60) that is injected into each
object's SH DC term for the segmentation passes (reference:
pegasus.py:218-234).  In PEGASUS-TPU the renderer emits exact per-pixel
object IDs, so these colors are only needed to *paint* the semantic
segmentation image — never to decode masks.
"""

from __future__ import annotations

import colorsys

import numpy as np


_SATURATION = 0.7  # must match the reference palette for sem_seg parity
_LIGHTNESS = 0.6


def generate_colors(n: int, mode: str = "bgr") -> np.ndarray:
    """n evenly-spaced HLS colors as float32 [n, 3] in [0,1]."""
    if mode not in ("bgr", "rgb"):
        raise ValueError(f"unknown channel order {mode!r}; use 'bgr' or 'rgb'")
    hues = np.arange(n) / max(n, 1)
    rgb = np.asarray(
        [colorsys.hls_to_rgb(h, _LIGHTNESS, _SATURATION) for h in hues],
        dtype=np.float32,
    ).reshape(n, 3)
    return rgb[:, ::-1].copy() if mode == "bgr" else rgb
