"""Build this package's types from plain numpy arrays.

The bridge for holding the port against the JAX reference: a caller turns a
reference object into a dict of numpy arrays (``{f: np.asarray(getattr(obj,
f))}``) and both packages then see the same values.  Numpy only here.
"""

from __future__ import annotations

import numpy as np
import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.gs.model import GaussianModel
from pegasus_tpu_torch.physics.rigid_body import RigidBodyParams, RigidBodyState
from pegasus_tpu_torch.training.trainer import GROUPS, TrainState

CLOUD_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot", "object_id", "alive")
CAMERA_FIELDS = ("R_w2c", "t_w2c", "fovx", "fovy", "width", "height")


def cloud_from_numpy(d: dict, device=DEFAULT_DEVICE) -> GaussianCloud:
    """{field: array} with every ``CLOUD_FIELDS`` key -> GaussianCloud."""
    return GaussianCloud.create(**{f: np.asarray(d[f]) for f in CLOUD_FIELDS}, device=device)


def gaussian_model_from_numpy(d: dict, sh_degree: int = 3, device=DEFAULT_DEVICE) -> GaussianModel:
    """A ``GaussianModel`` facade over ``cloud_from_numpy(d)``: ``d`` holds
    the arrays of a reference model's cloud ({field: array}, every
    ``CLOUD_FIELDS`` key)."""
    model = GaussianModel(sh_degree, device=device)
    model.cloud = cloud_from_numpy(d, device=device)
    return model


def camera_from_numpy(d: dict, device=DEFAULT_DEVICE) -> Camera:
    """{field: array or scalar} with every ``CAMERA_FIELDS`` key -> Camera."""
    return Camera.create(*(d[f] for f in CAMERA_FIELDS), device=device)


def cameras_from_numpy(d: dict, device=DEFAULT_DEVICE) -> list:
    """A stacked camera batch ({field: array with a leading batch axis} with
    every ``CAMERA_FIELDS`` key; ``width`` and ``height`` may be scalars) ->
    the list of cameras that ``make_dp_train_step`` and the sharded renders
    take."""
    n = np.asarray(d["R_w2c"]).shape[0]
    at = lambda v, i: v if np.ndim(v) == 0 else np.asarray(v)[i]
    return [camera_from_numpy({f: at(d[f], i) for f in CAMERA_FIELDS}, device=device)
            for i in range(n)]


def train_state_from_numpy(d: dict, device=DEFAULT_DEVICE) -> TrainState:
    """A training state from numpy: ``cloud`` ({field: array}, every
    ``CLOUD_FIELDS`` key), ``mu`` / ``nu`` ({group: array}, Adam's moments of
    each parameter group), ``count`` ({group: int}, optax's update count of
    each group; they must agree), ``xyz_grad_accum``, ``denom``, ``step``,
    ``spatial_lr_scale`` and, optionally, ``max_radii2d`` (zeros otherwise).
    Both packages can then continue from one mid-training state."""
    device = resolve_device(device)
    counts = {int(d["count"][g]) for g in GROUPS}
    if len(counts) != 1:
        raise ValueError(f"Adam counts differ between groups: {d['count']}")
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    cap = np.asarray(d["denom"]).shape[0]
    return TrainState(
        cloud=cloud_from_numpy(d["cloud"], device=device),
        mu={g: f32(d["mu"][g]) for g in GROUPS},
        nu={g: f32(d["nu"][g]) for g in GROUPS},
        count=counts.pop(),
        xyz_grad_accum=f32(d["xyz_grad_accum"]),
        denom=f32(d["denom"]),
        max_radii2d=f32(d.get("max_radii2d", np.zeros(cap))),
        step=int(d["step"]),
        spatial_lr_scale=float(d["spatial_lr_scale"]),
    )


def rigid_body_from_numpy(params: dict, state: dict, device=DEFAULT_DEVICE):
    """(RigidBodyParams, RigidBodyState) from two {field: array} dicts, the
    arrays keeping their dtypes (float32, bool, int32); ``num_hull_parts``
    stays a plain int and a field left out of ``params`` takes the
    dataclass's default."""
    device = resolve_device(device)
    tensor = lambda v: torch.tensor(np.asarray(v), device=device)
    fields = {k: int(v) if k == "num_hull_parts" else tensor(v)
              for k, v in params.items() if v is not None}
    return (RigidBodyParams(**fields),
            RigidBodyState(**{k: tensor(state[k]) for k in ("pos", "rot", "linvel", "angvel")}))
