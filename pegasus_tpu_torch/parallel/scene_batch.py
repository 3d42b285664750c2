"""Scene-variant generation on one device.

Port of ``pegasus_tpu/parallel/scene_batch.py``: V randomized drops of one
scene are simulated to rest as ONE batched physics program
(``rigid_body.simulate_batch`` over the variant axis), then each variant is
posed and rendered once by the port's ``rasterize`` (one launch of the tile
compositor kernel per variant: the reference's ``lax.map`` is a Python loop
here).  The reference shards the variant axis over a device mesh; that part
is not ported (ROADMAP M11), so there is no ``mesh`` argument.

The start states come from an explicit ``torch.Generator`` on the CPU, so a
seed means the same drops on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.physics import rigid_body as rb
from pegasus_tpu_torch.physics.heightfield import Heightfield
from pegasus_tpu_torch.scene.composition import SceneTemplate, pose_scene
from pegasus_tpu_torch.utils import quaternion as quat


class SceneBatchResult(NamedTuple):
    rgb: torch.Tensor  # [V, H, W, 3]
    depth: torch.Tensor  # [V, H, W]
    seg_weights: torch.Tensor  # [V, H, W, K]
    vis_weights: torch.Tensor  # [V, H, W, K]
    amodal: torch.Tensor  # [V, H, W, K]
    final_pos: torch.Tensor  # [V, B, 3] rest poses
    final_rot: torch.Tensor  # [V, B, 4] wxyz


def variant_start_states(
    n_variants: int,
    n_bodies: int,
    drop_height=(0.25, 0.45),
    drop_region=(0.15, 0.15),
    generator: Optional[torch.Generator] = None,
    device=DEFAULT_DEVICE,
) -> rb.RigidBodyState:
    """[V, B, ...] start states of the reference's drop randomization:
    uniform xy in the drop region, uniform height, an unnormalized
    uniform(0,1)^4 quaternion (normalized here); body 0, the environment,
    sits at the origin with identity orientation.  Drawn on the CPU from
    ``generator`` in the order quaternions, xy, z."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    q = quat.normalize(torch.rand((n_variants, n_bodies, 4), generator=generator))
    q[:, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    half = torch.tensor([drop_region[0], drop_region[1]], dtype=torch.float32)
    xy = (2.0 * torch.rand((n_variants, n_bodies, 2), generator=generator) - 1.0) * half
    z = drop_height[0] + (drop_height[1] - drop_height[0]) * torch.rand(
        (n_variants, n_bodies), generator=generator
    )
    pos = torch.cat([xy, z[..., None]], dim=-1)
    pos[:, 0] = 0.0
    return rb.RigidBodyState.rest(pos, q, device=device)


def generate_scene_variants(
    template: SceneTemplate,
    physics_params: rb.RigidBodyParams,
    cam: Camera,
    n_variants: int,
    n_steps: int = 310,
    drop_height=(0.25, 0.45),
    drop_region=(0.15, 0.15),
    seed: int = 0,
    max_objects: int = 8,
    generator: Optional[torch.Generator] = None,
    heightfield: Optional[Heightfield] = None,
    device=DEFAULT_DEVICE,
) -> SceneBatchResult:
    """Randomize drops, simulate to rest, render: V variants.

    ``physics_params`` (``[B, ...]``, shared by every variant) and
    ``template`` describe one scene; the drops are drawn from ``generator``
    (default: a CPU generator seeded with ``seed``).  Returns every output
    stacked over the variant axis, on ``device``.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    n_bodies = template.num_bodies
    states = variant_start_states(
        n_variants, n_bodies, drop_height, drop_region, generator, device
    )
    _, final = rb.simulate_batch(
        physics_params, states, n_steps=n_steps, heightfield=heightfield, device=device
    )
    body_R = quat.quat_to_rotmat(final.rot)  # [V, B, 3, 3]
    body_R[:, 0] = torch.eye(3, dtype=torch.float32, device=device)
    body_t = final.pos.clone()
    body_t[:, 0] = 0.0

    outs = []
    with torch.no_grad():
        for v in range(n_variants):
            scene = pose_scene(template, body_R[v, :n_bodies], body_t[v, :n_bodies])
            outs.append(rasterize(scene, cam, max_objects=max_objects))
    stack = lambda name: torch.stack([getattr(o, name) for o in outs], dim=0)
    return SceneBatchResult(
        rgb=stack("rgb"),
        depth=stack("depth"),
        seg_weights=stack("seg_weights"),
        vis_weights=stack("vis_weights"),
        amodal=stack("amodal"),
        final_pos=final.pos,
        final_rot=final.rot,
    )
