"""Build this package's types from plain numpy arrays.

The bridge for holding the port against the JAX reference: a caller turns a
reference object into a dict of numpy arrays (``{f: np.asarray(getattr(obj,
f))}``) and both packages then see the same values.  Numpy only here.
"""

from __future__ import annotations

import numpy as np

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import GaussianCloud

CLOUD_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot", "object_id", "alive")
CAMERA_FIELDS = ("R_w2c", "t_w2c", "fovx", "fovy", "width", "height")


def cloud_from_numpy(d: dict, device="cpu") -> GaussianCloud:
    """{field: array} with every ``CLOUD_FIELDS`` key -> GaussianCloud."""
    return GaussianCloud.create(**{f: np.asarray(d[f]) for f in CLOUD_FIELDS}, device=device)


def camera_from_numpy(d: dict, device="cpu") -> Camera:
    """{field: array or scalar} with every ``CAMERA_FIELDS`` key -> Camera."""
    return Camera.create(*(d[f] for f in CAMERA_FIELDS), device=device)
