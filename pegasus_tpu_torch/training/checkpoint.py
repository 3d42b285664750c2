"""Training checkpoint/restore (capture/restore equivalent).

Port of ``pegasus_tpu/training/checkpoint.py``.  The reference serializes
(model tensors, optimizer state, iteration) via torch checkpoints
(reference: src/gs/gaussian_model.py:71-103, gs_training.py:23-24,46-47);
the JAX package writes its TrainState pytree with orbax.  Here the
TrainState's tensors, moments and counters go through ``torch.save`` as one
dictionary of host tensors and numbers.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.training.trainer import TrainState


def _to_dict(state: TrainState) -> dict:
    cloud = {f.name: getattr(state.cloud, f.name).cpu() for f in dataclasses.fields(GaussianCloud)}
    return {
        "cloud": cloud,
        "mu": {g: v.cpu() for g, v in state.mu.items()},
        "nu": {g: v.cpu() for g, v in state.nu.items()},
        "count": int(state.count),
        "xyz_grad_accum": state.xyz_grad_accum.cpu(),
        "denom": state.denom.cpu(),
        "max_radii2d": state.max_radii2d.cpu(),
        "step": int(state.step),
        "spatial_lr_scale": float(state.spatial_lr_scale),
    }


def save_checkpoint(state: TrainState, path) -> None:
    """Write a TrainState checkpoint to ``path`` (parents created)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_dict(state), path)


def restore_checkpoint(state_template: TrainState, path) -> TrainState:
    """Restore into the shape and device of ``state_template``; raises if
    a field's shape or dtype differs from the template's."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    data = torch.load(path, map_location="cpu", weights_only=True)
    dev = state_template.cloud.device

    def like(saved: torch.Tensor, want: torch.Tensor, name: str) -> torch.Tensor:
        if saved.shape != want.shape or saved.dtype != want.dtype:
            raise ValueError(
                f"checkpoint {name}: {saved.dtype} {tuple(saved.shape)}, "
                f"template {want.dtype} {tuple(want.shape)}"
            )
        return saved.to(dev)

    cloud = GaussianCloud(**{
        f.name: like(data["cloud"][f.name], getattr(state_template.cloud, f.name), f.name)
        for f in dataclasses.fields(GaussianCloud)
    })
    return TrainState(
        cloud=cloud,
        mu={g: like(data["mu"][g], v, f"mu.{g}") for g, v in state_template.mu.items()},
        nu={g: like(data["nu"][g], v, f"nu.{g}") for g, v in state_template.nu.items()},
        count=data["count"],
        xyz_grad_accum=like(data["xyz_grad_accum"], state_template.xyz_grad_accum, "xyz_grad_accum"),
        denom=like(data["denom"], state_template.denom, "denom"),
        max_radii2d=like(data["max_radii2d"], state_template.max_radii2d, "max_radii2d"),
        step=data["step"],
        spatial_lr_scale=data["spatial_lr_scale"],
    )
