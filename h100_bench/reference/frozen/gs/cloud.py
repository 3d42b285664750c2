"""Frozen copy of pegasus_tpu_torch/gs/cloud.py at commit 7a69f88, cut to what the benchmark calls.

Gaussian-splat cloud: a dataclass of tensors in the Inria raw parameterization.

Port of ``pegasus_tpu/gs/cloud.py``.  Parameters are stored pre-activation
(log-scales, logit-opacities, unnormalized wxyz quaternions); an
``object_id`` channel tags each splat with its body (0 = environment), and
``alive`` marks padding splats, which render nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from reference.frozen.device import DEFAULT_DEVICE, resolve_device
from reference.frozen.utils import quaternion as quat

_SH_DEGREE_OF_REST = {0: 0, 3: 1, 8: 2, 15: 3}


@dataclass(frozen=True)
class GaussianCloud:
    """A batch of N Gaussian splats (raw parameterization).

      xyz       [N, 3]      float32 positions
      f_dc      [N, 1, 3]   DC SH coefficient per channel
      f_rest    [N, 15, 3]  higher-order SH (deg 3); [N, 0, 3] for deg 0
      opacity   [N, 1]      logit opacity
      scale     [N, 3]      log scales
      rot       [N, 4]      wxyz quaternion (normalized on use)
      object_id [N]         int32 body id (0 = environment)
      alive     [N]         bool, False for padding splats

    A cloud posed C ways at once (``scene.composition.pose_scene`` of C
    poses) holds xyz [C, N, 3], rot [C, N, 4] and f_rest [C, N, R, 3]; its
    other fields and ``num_splats`` are per splat, and only
    ``project_gaussians`` and ``pose_frame`` read it.
    """

    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    opacity: torch.Tensor
    scale: torch.Tensor
    rot: torch.Tensor
    object_id: torch.Tensor
    alive: torch.Tensor

    @classmethod
    def create(
        cls,
        xyz,
        f_dc,
        f_rest,
        opacity,
        scale,
        rot,
        object_id=None,
        alive=None,
        device=DEFAULT_DEVICE,
    ) -> "GaussianCloud":
        """Build from numpy arrays (or CPU tensors), copied onto ``device``."""
        device = resolve_device(device)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        xyz = f32(xyz)
        n = xyz.shape[0]
        if object_id is None:
            object_id = np.zeros((n,), np.int32)
        if alive is None:
            alive = np.ones((n,), bool)
        return cls(
            xyz=xyz,
            f_dc=f32(f_dc).reshape(n, 1, 3),
            f_rest=f32(f_rest).reshape(n, -1, 3),
            opacity=f32(opacity).reshape(n, 1),
            scale=f32(scale).reshape(n, 3),
            rot=f32(rot).reshape(n, 4),
            object_id=torch.tensor(np.asarray(object_id, np.int32), device=device).reshape(n),
            alive=torch.tensor(np.asarray(alive, bool), device=device).reshape(n),
        )

    def replace(self, **changes) -> "GaussianCloud":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "GaussianCloud":
        return GaussianCloud(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def num_splats(self) -> int:
        return self.alive.shape[0]

    @property
    def sh_degree(self) -> int:
        return _SH_DEGREE_OF_REST[self.f_rest.shape[-2]]

    def pose_frame(self, j: int) -> "GaussianCloud":
        """Pose ``j`` of a cloud posed C ways: an ordinary cloud (views)."""
        return self.replace(xyz=self.xyz[j], rot=self.rot[j], f_rest=self.f_rest[j])

    # -- activations -------------------------------------------------------

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scale)

    def get_opacity(self) -> torch.Tensor:
        a = torch.sigmoid(self.opacity)
        return torch.where(self.alive[:, None], a, torch.zeros_like(a))

    def get_rotation(self) -> torch.Tensor:
        return quat.normalize(self.rot)

    def get_features(self) -> torch.Tensor:
        """[N, 1 + R, 3] concatenated SH (DC first); [C, N, 1 + R, 3] for a
        cloud posed C ways."""
        f_dc = self.f_dc if self.f_rest.dim() == 3 else self.f_dc.expand(*self.f_rest.shape[:-2], 1, 3)
        return torch.cat([f_dc, self.f_rest], dim=-2)


    def centroid(self) -> torch.Tensor:
        """Mean of alive splat positions (the body's rotation pivot)."""
        w = self.alive.to(torch.float32)[:, None]
        return torch.sum(self.xyz * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)

    # -- functional SE(3) ----------------------------------------------------


    # -- composition -------------------------------------------------------

    def with_object_id(self, object_id: int) -> "GaussianCloud":
        return self.replace(
            object_id=torch.full_like(self.object_id, int(object_id))
        )


    def padded(self, n_total: int) -> "GaussianCloud":
        """Pad with dead splats (alive=False, zero opacity) to ``n_total``."""
        n = self.num_splats
        if n_total < n:
            raise ValueError(f"padded: n_total={n_total} < num_splats={n}")
        extra = n_total - n
        if extra == 0:
            return self

        def pad(x, fill=0.0):
            tail = torch.full((extra,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=0)

        rot_tail = torch.zeros((extra, 4), dtype=self.rot.dtype, device=self.rot.device)
        rot_tail[:, 0] = 1.0
        return GaussianCloud(
            xyz=pad(self.xyz),
            f_dc=pad(self.f_dc),
            f_rest=pad(self.f_rest),
            opacity=pad(self.opacity, -100.0),  # sigmoid -> 0
            scale=pad(self.scale, -20.0),  # exp -> ~0
            rot=torch.cat([self.rot, rot_tail], dim=0),
            object_id=pad(self.object_id, 0),
            alive=pad(self.alive, False),
        )


def merge(clouds: Sequence[GaussianCloud]) -> GaussianCloud:
    """Concatenate clouds (done once per scene, not per frame)."""
    return GaussianCloud(
        **{
            f.name: torch.cat([getattr(c, f.name) for c in clouds], dim=0)
            for f in dataclasses.fields(GaussianCloud)
        }
    )
