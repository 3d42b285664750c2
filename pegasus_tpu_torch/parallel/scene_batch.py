"""Scene-variant generation, on one device or over a mesh of lanes.

Port of ``pegasus_tpu/parallel/scene_batch.py``: V randomized drops of one
scene are simulated to rest as ONE batched physics program
(``rigid_body.simulate_batch`` over the variant axis), then the variants are
posed and rendered in chunks of ``VARIANT_CHUNK``: a chunk is the template
posed once per variant (pose by pose) under one camera stacked as many
times, rendered by one ``rasterize_chunk`` (one projection, one binning host
read and one launch of the tile compositor kernel).  The reference maps its
variants one by one (``lax.map``); every variant here has the bits that
``rasterize`` of it alone gives, whatever the chunk.  With ``mesh=`` (a
1-D 'scene' mesh, ``parallel/mesh.py``) the variant axis is cut into one
contiguous slice per lane: the physics stays one ``simulate_batch`` per
device of the mesh, over the variants of that device's lanes, each lane
poses and renders its slice in chunks, and the outputs are gathered on the
first lane's device in variant order, one copy per chunk.

The start states come from an explicit ``torch.Generator`` on the CPU, so a
seed means the same drops on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pegasus_tpu_torch.camera import Camera, CameraBatch
from pegasus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize_chunk
from pegasus_tpu_torch.parallel.mesh import Lane, Mesh, lane_slices, map_lanes, to_device
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


RENDER_FIELDS = SceneBatchResult._fields[:5]  # what each variant's render gives
VARIANT_CHUNK = 8  # variants per set of launches: the reference's frame_chunk default


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
    mesh: Optional[Mesh] = None,
    max_objects: int = 8,
    rasterize_fn=None,
    rasterize_kwargs: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
    heightfield: Optional[Heightfield] = None,
    device=DEFAULT_DEVICE,
) -> SceneBatchResult:
    """Randomize drops, simulate to rest, render: V variants.

    ``physics_params`` (``[B, ...]``, shared by every variant) and
    ``template`` describe one scene; the drops are drawn from ``generator``
    (default: a CPU generator seeded with ``seed``).  Returns every output
    stacked over the variant axis, on ``device`` or, with ``mesh``, on the
    mesh's first device (``device`` is not read then).  With
    ``rasterize_fn=None`` the variants render in chunks of
    ``VARIANT_CHUNK`` (``rasterize_chunk``: one forward launch per chunk);
    a given ``rasterize_fn`` renders each variant as the reference calls
    it, ``rasterize_fn(scene, cam, max_objects=, **rasterize_kwargs)``
    (the reference's default off TPU is ``ops.rasterize_tiled``'s
    ``rasterize_tiled`` at ``max_per_tile=512``).
    """
    rasterize_kwargs = rasterize_kwargs or {}
    lanes = mesh.lanes() if mesh is not None else [Lane(resolve_device(device))]
    home = lanes[0].device
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    n_bodies = template.num_bodies
    states = variant_start_states(
        n_variants, n_bodies, drop_height, drop_region, generator, home
    )
    cuts = lane_slices(n_variants, len(lanes))

    # one drop per device, over the variants of that device's lanes
    finals = [None] * len(lanes)
    for dev in dict.fromkeys(lane.device for lane in lanes):
        mine = [i for i, lane in enumerate(lanes) if lane.device == dev]
        index = torch.cat([torch.arange(cuts[i].start, cuts[i].stop) for i in mine])
        if index.numel() == 0:
            continue
        picked = rb.RigidBodyState(**{f: getattr(states, f)[index.to(home)]
                                      for f in ("pos", "rot", "linvel", "angvel")})
        _, final = rb.simulate_batch(
            physics_params, picked, n_steps=n_steps, heightfield=heightfield, device=dev
        )
        lo = 0
        for i in mine:
            n = cuts[i].stop - cuts[i].start
            finals[i] = (final.pos[lo : lo + n], final.rot[lo : lo + n])
            lo += n

    per_device = {dev: (to_device(template, dev), to_device(cam, dev))
                  for dev in dict.fromkeys(lane.device for lane in lanes)}

    def render_slice(lane, final):
        pos, rot = final
        tmpl, camera = per_device[lane.device]
        body_R = quat.quat_to_rotmat(rot)  # [v, B, 3, 3]
        body_R[:, 0] = torch.eye(3, dtype=torch.float32, device=lane.device)
        body_t = pos.clone()
        body_t[:, 0] = 0.0
        n = pos.shape[0]
        chunk = max(1, min(VARIANT_CHUNK, n))
        cams = CameraBatch.stack([camera] * chunk)
        outs = []
        with torch.no_grad():
            if rasterize_fn is not None:
                for v in range(n):
                    scene = pose_scene(tmpl, body_R[v, :n_bodies], body_t[v, :n_bodies])
                    out = rasterize_fn(scene, camera, max_objects=max_objects, **rasterize_kwargs)
                    outs.append(tuple(getattr(out, name)[None].to(home) for name in RENDER_FIELDS))
                return outs
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                scene = pose_scene(tmpl, body_R[lo:hi, :n_bodies], body_t[lo:hi, :n_bodies])
                out = rasterize_chunk(scene, cams[: hi - lo], max_objects=max_objects)
                outs.append(tuple(getattr(out, name).to(home) for name in RENDER_FIELDS))
        return outs

    busy = [i for i, f in enumerate(finals) if f is not None]
    rendered = map_lanes([lanes[i] for i in busy], render_slice, [finals[i] for i in busy])
    outs = [o for lane_outs in rendered for o in lane_outs]
    stacked = {name: torch.cat([o[j] for o in outs], dim=0)
               for j, name in enumerate(RENDER_FIELDS)}
    return SceneBatchResult(
        **stacked,
        final_pos=torch.cat([finals[i][0].to(home) for i in busy], dim=0),
        final_rot=torch.cat([finals[i][1].to(home) for i in busy], dim=0),
    )
