"""Frozen copy of pegasus_tpu_torch/ops/rasterize_ref.py at commit 7a69f88, cut to what the benchmark calls.

Golden-model compositor: exact alpha-compositing semantics in plain torch.

Port of ``pegasus_tpu/ops/rasterize_ref.py``, the oracle the tile
compositor is held against.  One pass over depth-sorted splats emits every
modality: RGB, expected depth, accumulated alpha, per-object visible
weights (with and without the environment) and per-object amodal
accumulations.  Front-to-back 'over' is a scan over depth-ordered splat
chunks with an exclusive cumulative product of (1 - alpha) inside each
chunk.  Cost is O(pixels x splats): clarity over speed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor  # [H, W, 3] composited color incl. background
    depth: torch.Tensor  # [H, W] expected camera-space depth (sum w_i * z_i)
    alpha: torch.Tensor  # [H, W] accumulated opacity of the full scene
    seg_weights: torch.Tensor  # [H, W, K] per-object visible weight, full scene
    vis_weights: torch.Tensor  # [H, W, K] same but environment splats removed
    amodal: torch.Tensor  # [H, W, K] per-object standalone accumulated alpha


