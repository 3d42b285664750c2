"""Frozen copy of pegasus_tpu_torch/scene/composition.py at commit 7a69f88.

Scene composition: one merged cloud, per-body poses applied per splat.

Port of ``pegasus_tpu/scene/composition.py``.  The environment and the
canonical (unposed) objects merge ONCE into a ``SceneTemplate`` whose
``object_id`` is the body id; a pose gathers each splat's body rotation and
translation by that id and applies the xyz, per-splat quaternion and SH-band
rotations to the whole cloud at once.  Poses are absolute samples of the
physics trajectory, rotating each body about its canonical centroid.  The
gather is plain indexing (the reference's one-hot matmul, lines 84-90, is a
TPU workaround).  ``pose_scene`` also takes C poses at once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from reference.frozen.device import DEFAULT_DEVICE, resolve_device
from reference.frozen.gs.cloud import GaussianCloud, merge
from reference.frozen.utils import quaternion as quat
from reference.frozen.utils import sh as shlib


@dataclass(frozen=True)
class SceneTemplate:
    """Merged canonical scene cloud + per-body metadata.

    body index == bullet body id (0 = environment, objects 1..B-1), matching
    the trajectory JSON ids.
    """

    cloud: GaussianCloud  # merged, object_id = body id
    pivots: torch.Tensor  # [B, 3] canonical per-body rotation pivot (centroid)
    num_bodies: int

    @classmethod
    def build(
        cls,
        env: GaussianCloud,
        objects: Sequence[GaussianCloud],
        pad_to: int | None = None,
    ) -> "SceneTemplate":
        clouds = [env.with_object_id(0)]
        pivots = [torch.zeros(3, dtype=torch.float32, device=env.device)]  # env never rotates
        for i, obj in enumerate(objects):
            clouds.append(obj.with_object_id(i + 1))
            pivots.append(obj.centroid())
        scene = merge(clouds)
        if pad_to is not None:
            scene = scene.padded(pad_to)
        return cls(cloud=scene, pivots=torch.stack(pivots, dim=0), num_bodies=len(objects) + 1)

    def replace(self, **updates) -> "SceneTemplate":
        return dataclasses.replace(self, **updates)


def pose_scene(
    template: SceneTemplate,
    body_R: torch.Tensor,  # [B, 3, 3], or [C, B, 3, 3] for C poses
    body_t: torch.Tensor,  # [B, 3], or [C, B, 3]
) -> GaussianCloud:
    """Apply per-body rigid poses to the merged scene cloud: each body
    rotates about its centroid, then translates; splat quaternions are
    premultiplied by the body rotation and SH bands 1..3 rotate with it.

    C poses (a chunk of dynamic frames, which the reference poses inside its
    ``lax.map``) give a cloud whose xyz, rot and f_rest carry a leading pose
    axis.  Each pose is applied alone, as the reference's map applies it:
    a batched matmul may round otherwise than the per-pose one, and a pose
    must give the same bits in a chunk of any size."""
    if body_R.dim() == 4:
        posed = [pose_scene(template, R, t) for R, t in zip(body_R, body_t)]
        return posed[0].replace(**{name: torch.stack([getattr(c, name) for c in posed])
                                   for name in ("xyz", "rot", "f_rest")})
    cloud = template.cloud
    bid = torch.clamp(cloud.object_id.long(), 0, template.num_bodies - 1)

    R_g = body_R[bid]  # [N, 3, 3]
    p_g = template.pivots[bid]
    rel = cloud.xyz - p_g
    new_xyz = (R_g @ rel[:, :, None])[:, :, 0] + p_g + body_t[bid]

    new_rot = quat.quat_mul(quat.rotmat_to_quat(body_R)[bid], cloud.get_rotation())

    f_rest = cloud.f_rest
    if f_rest.shape[1] > 0:
        outs = []
        start = 0
        for band in range(1, cloud.sh_degree + 1):
            dim = shlib._BAND_DIMS[band]
            D = shlib.sh_band_rotation(body_R, band)  # [B, dim, dim]
            outs.append(D[bid] @ f_rest[:, start : start + dim])
            start += dim
        if start < f_rest.shape[1]:
            outs.append(f_rest[:, start:])
        f_rest = torch.cat(outs, dim=1)

    return cloud.replace(xyz=new_xyz, rot=new_rot, f_rest=f_rest)


def poses_from_trajectory_step(times_t, times_q_xyzw, step, device=DEFAULT_DEVICE):
    """Dense per-body (R [B,3,3], t [B,3]) float32 at a timestep, or
    (R [C,B,3,3], t [C,B,3]) at each of a sequence of C timesteps (one
    host-to-device copy for all of them).

    times_t: [B, T, 3]; times_q_xyzw: [B, T, 4] (Bullet layout).  Body 0
    (environment) is forced to identity: the env cloud is never posed."""
    device = resolve_device(device)
    steps = np.asarray(step)
    t = torch.tensor(np.moveaxis(np.asarray(times_t)[:, steps, :], 0, -2), dtype=torch.float32, device=device)
    q = torch.tensor(np.moveaxis(np.asarray(times_q_xyzw)[:, steps, :], 0, -2), dtype=torch.float32,
                     device=device)
    R = quat.quat_to_rotmat(quat.xyzw_to_wxyz(q))
    R[..., 0, :, :] = torch.eye(3, dtype=torch.float32, device=device)
    t[..., 0, :] = 0.0
    return R, t
