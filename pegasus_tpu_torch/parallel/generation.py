"""Sharded end-to-end dataset generation: scene-DP over a mesh of lanes.

Port of ``pegasus_tpu/parallel/generation.py``.  The sequential path drops
and renders one scene after the other; here a batch of mesh-size scenes is
set up on the host, dropped as ONE batched physics program per device
(``rigid_body.simulate_batch`` over that device's scenes: params, start
states and heightfields stacked on a leading scene axis), and then every
scene renders its camera trajectory on its own lane (a device and a CUDA
stream of its own, ``parallel/mesh.py``) in chunks of ``config.frame_chunk``
frames.  A scene's draws, cameras, chunk loop, frame records and trajectory
JSON are the sequential path's own code (``pegasus.py``'s ``_draw_scene``,
``_scene_cameras``, ``_render_chunks``, ``_write_frame``;
``PhysicsEngine._trajectory``); this module keeps the batch over lanes, the
batched drop, the pinned buffers and the writer pool.  The reference's
batch program renders a scene's F frames as one program and reads no
``frame_chunk``; here the files do not depend on it.  Each lane copies its
scene's packed chunks into one pinned host buffer on its stream and hands
the two-worker writer pool an event to wait on; the pool unpacks the frames
and writes the BOP tree while the next batch is set up and dropped.

Order inside a batch: the drop of the whole batch has finished on the host
(its trajectory is copied back for the trajectory JSON) before any lane
starts to render, so a lane never runs beside the capture of a physics
step.  Writer threads of the previous batch may still wait on their events
at that moment, which is why ``rigid_body._StepProgram`` captures with
``capture_error_mode="thread_local"``.

What the reference does for XLA's static shapes is not ported: scenes are
not padded to ``config.splat_budget`` (the field stays in the config and is
read nowhere here), scenes with fewer objects carry no placeholder clouds
(absent bodies are ``body_mask = False`` slots of the physics batch), and
the short last batch is simply shorter.  Exact binning cannot overflow, so
``binning_overflow_frames`` is recorded as 0 and there is no warning.

Call via ``run_generation(config, envs, objs, mesh=mesh)`` or directly:

    from pegasus_tpu_torch.parallel.generation import run_generation_sharded
    stats = run_generation_sharded(config, env_list, obj_list, mesh=mesh)
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import CameraBatch
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.gs.ply import load_gs_ply
from pegasus_tpu_torch.io import colmap as colmap_io
from pegasus_tpu_torch.io.bop_writer import BOPDatasetWriter, write_models
from pegasus_tpu_torch.io.mesh import load_mesh
from pegasus_tpu_torch.ops.render import pack_frame_bytes, unpack_frame_bytes
from pegasus_tpu_torch.parallel.mesh import Mesh, make_mesh, map_lanes
from pegasus_tpu_torch.pegasus import _draw_scene, _render_chunks, _scene_cameras, _write_frame
from pegasus_tpu_torch.physics import rigid_body as rb
from pegasus_tpu_torch.physics.heightfield import Heightfield
from pegasus_tpu_torch.scene.composition import SceneTemplate, poses_from_trajectory_step
from pegasus_tpu_torch.utils import quaternion as quat
from pegasus_tpu_torch.utils.colors import generate_colors
from pegasus_tpu_torch.utils.observability import (SceneStats, completed_scene_ids,
                                                   retry_scene)

HF_RESOLUTION = 128  # uniform heightfield grid so scenes stack


def _scene_setup(config, env_list, obj_list, rng, preload, scene_id, device):
    """Host-side per-scene randomization with ``PEGASUS``'s own steps: the
    reference's draws in its order (environment, object count, the choice
    of objects, the engine's seed, one start position per object, then the
    camera trajectory).  The engine, the template and the cameras are built
    on ``device``, the scene's lane."""
    env, selected, engine = _draw_scene(
        rng, env_list, obj_list, config.min_num_objects, config.max_num_objects,
        asset_folder=config.urdf_asset_folder or str(Path(config.dataset_path) / "urdf"),
        dataset_dir=Path(config.dataset_base_path) / config.dataset_name,
        scene_id=scene_id,
        simulation_steps=config.simulation_steps,
        # the capacity must cover rich scenes AND be equal across the
        # batch (stacked params)
        max_bodies=max(8, config.max_num_objects + 1),
        device=device,
    )
    n_obj = len(selected)
    params, state0 = engine._build()
    hf = engine.heightfield
    if hf is None or hf.grid.shape[0] != HF_RESOLUTION:
        hf = Heightfield.flat(resolution=HF_RESOLUTION, device=device)

    env_entry = preload["envs"][env.object_name]
    clouds = [preload["objs"][o.object_name][device] for o in selected]
    # real bodies only, at their real size
    template = SceneTemplate.build(env_entry["gs"][device], clouds)
    cams, camera_intr, cam_extr_np = _scene_cameras(env_entry, config, rng, device)

    colors = np.zeros((config.max_num_objects, 3), np.float32)
    colors[:n_obj] = generate_colors(n_obj, mode="rgb")

    return dict(scene_id=scene_id, engine=engine, env=env, selected=selected, n_obj=n_obj,
                params=params, state0=state0, heightfield=hf, template=template, cams=cams,
                cam_extr_np=cam_extr_np, colors=colors, camera_intr=camera_intr)


def _stack_params(params: List[rb.RigidBodyParams]) -> rb.RigidBodyParams:
    """[S, B, ...] params of S scenes with equal body slots; the unrolled
    hull-part loop is sized for the scene that needs most."""
    fields = {}
    for name in params[0].__dataclass_fields__:
        values = [getattr(p, name) for p in params]
        fields[name] = (torch.stack(values, dim=0) if isinstance(values[0], torch.Tensor)
                        else max(values))
    return rb.RigidBodyParams(**fields)


def _drop_batch(setups, n_steps: int, device):
    """One ``simulate_batch`` over the scenes of one device -> per scene
    (times_t [B, T, 3], times_q xyzw [B, T, 4]) as numpy, real bodies only."""
    params = _stack_params([s["params"] for s in setups])
    state0 = rb.RigidBodyState(**{
        f: torch.stack([getattr(s["state0"], f) for s in setups], dim=0)
        for f in ("pos", "rot", "linvel", "angvel")
    })
    hf = Heightfield.stacked([s["heightfield"] for s in setups])
    engine = setups[0]["engine"]
    traj, _ = rb.simulate_batch(
        params, state0, n_steps=n_steps, dt=engine.dt, gravity=engine.gravity,
        heightfield=hf, device=device,
    )
    pos = traj.pos.cpu().numpy()  # [S, T, B, 3]
    rot = quat.wxyz_to_xyzw(traj.rot).cpu().numpy()  # [S, T, B, 4]
    out = []
    for i, setup in enumerate(setups):
        nb = 1 + setup["n_obj"]
        out.append((np.transpose(pos[i], (1, 0, 2))[:nb], np.transpose(rot[i], (1, 0, 2))[:nb]))
    return out


def _render_scene(lane, setup, frame_steps, static_pose: bool, background, frame_chunk: int,
                  rasterize_fn=None, rasterize_kwargs=None):
    """One scene's frames on its lane through ``PEGASUS``'s chunk loop
    (``pegasus._render_chunks``, with ``rasterize_fn`` and its keywords):
    each chunk's ``pack_frame_bytes`` is copied into the scene's pinned
    host buffer on the lane's stream.  Every frame has the bits it has in
    a chunk of one.  Returns (packed [F, H, W, C] uint8 on the host,
    body_R [F, B, 3, 3], body_t [F, B, 3], event that completes with the
    copies or None on the CPU)."""
    dev = lane.device
    colors = torch.tensor(setup["colors"], dtype=torch.float32, device=dev)
    n_frames = len(setup["cams"])
    on_card = dev.type == "cuda"

    def to_host(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card).copy_(t, non_blocking=True)

    with torch.no_grad():
        body_R, body_t = poses_from_trajectory_step(
            setup["times_t"], setup["times_q"], int(frame_steps[0]) if static_pose else frame_steps,
            device=dev,
        )
        chunks = _render_chunks(setup["template"], body_R, body_t, not static_pose,
                                CameraBatch.stack(setup["cams"]), colors, frame_chunk, background,
                                rasterize_fn, rasterize_kwargs)
        packed_h = None
        for lo, hi, enc in chunks:
            packed = pack_frame_bytes(enc)
            if packed_h is None:
                packed_h = torch.empty((n_frames,) + packed.shape[1:], dtype=packed.dtype,
                                       pin_memory=on_card)
            packed_h[lo:hi].copy_(packed, non_blocking=True)
        if static_pose:  # scene_gt reads a pose per frame
            body_R, body_t = (p.expand(n_frames, *p.shape) for p in (body_R, body_t))
        body_R_h, body_t_h = to_host(body_R), to_host(body_t)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return packed_h, body_R_h, body_t_h, event


def run_generation_sharded(
    config: GenerationConfig,
    env_list: List[Asset],
    obj_list: List[Asset],
    mesh: Mesh = None,
    rasterize_fn=None,
    rasterize_kwargs: Optional[dict] = None,
) -> SceneStats:
    """Generate ``config.num_scenes`` scenes in mesh-sized batches.
    ``mesh=None`` is a 1-D 'scene' mesh with one lane per visible card.
    Each lane renders its scene in chunks of ``config.frame_chunk`` frames:
    with ``rasterize_fn=None`` one forward launch per chunk
    (``rasterize_chunk``), else ``rasterize_fn(scene, cam, background=,
    max_objects=, **rasterize_kwargs)`` per frame (the reference's default
    off TPU is ``ops.rasterize_tiled.rasterize_tiled``)."""
    if mesh is None:
        mesh = make_mesh(axis_names=("scene",))
    lanes = mesh.lanes()
    devices = mesh.distinct_devices()
    n_dev = len(lanes)
    out_root = Path(config.dataset_base_path)
    dataset_dir = out_root / config.dataset_name
    dataset_dir.mkdir(parents=True, exist_ok=True)
    config.save(dataset_dir / "generation_config.json")

    rng = np.random.default_rng(config.seed)

    # preload GS clouds (one copy per device of the mesh) + COLMAP poses once
    preload = {"envs": {}, "objs": {}}
    load_iter = 30_000
    for env in env_list:
        reco = Path(env.reconstruction_path)
        cloud = load_gs_ply(env.gaussian_point_cloud_path(load_iter), device=devices[0])
        preload["envs"][env.object_name] = {
            "gs": {d: cloud.to(d) for d in devices},
            "cam_extr": colmap_io.read_images_binary(reco / "sparse/0/images.bin"),
            "cam_intr": colmap_io.read_cameras_binary(reco / "sparse/0/cameras.bin"),
        }
    for obj in obj_list:
        obj.mode = "fused"
        cloud = load_gs_ply(obj.gaussian_point_cloud_path(load_iter), device=devices[0])
        preload["objs"][obj.object_name] = {d: cloud.to(d) for d in devices}

    models = {
        obj.ID: load_mesh(obj.urdf_obj_path)
        for obj in obj_list
        if Path(obj.urdf_obj_path).exists()
    }
    if models:
        write_models(models, dataset_dir / "models", config.unit_scale)

    n_frames = config.num_cameras * config.num_camera_interpolation_steps
    if config.mode == "dynamic":
        frame_steps = np.clip(
            np.arange(n_frames), 0, config.simulation_steps - 1
        ).astype(np.int32)
    else:
        frame_steps = np.full(
            n_frames, config.simulation_steps - 1, np.int32
        )
    static_pose = config.mode != "dynamic"

    stats = SceneStats(path=str(dataset_dir / "generation_stats.jsonl"))
    scene_ids = list(range(1, config.num_scenes + 1))
    if config.resume:
        done = completed_scene_ids(out_root, config.dataset_name)
        scene_ids = [s for s in scene_ids if s not in done]

    def one_batch(batch_ids) -> None:
        t0 = time.perf_counter()
        batch_lanes = lanes[: len(batch_ids)]
        setups = [
            _scene_setup(config, env_list, obj_list, rng, preload, sid, lane.device)
            for sid, lane in zip(batch_ids, batch_lanes)
        ]
        t_setup = time.perf_counter() - t0

        # one drop per device over that device's scenes; every drop has
        # ended (its trajectory is on the host) before a lane renders
        t1 = time.perf_counter()
        for dev in devices:
            on_dev = [s for s, lane in zip(setups, batch_lanes) if lane.device == dev]
            if not on_dev:
                continue
            for setup, (times_t, times_q) in zip(
                on_dev, _drop_batch(on_dev, config.simulation_steps, dev)
            ):
                setup["times_t"], setup["times_q"] = times_t, times_q
        t_physics = time.perf_counter() - t1

        t2 = time.perf_counter()
        rendered = map_lanes(
            batch_lanes,
            lambda lane, setup: _render_scene(
                lane, setup, frame_steps, static_pose, config.background,
                config.frame_chunk, rasterize_fn, rasterize_kwargs,
            ),
            setups,
        )
        t_render = time.perf_counter() - t2

        # host writes (event wait + unpack + PNG/JSON) run on the writer
        # pool so the NEXT batch's setup + device work overlap them
        for setup, (packed, body_R, body_t, event) in zip(setups, rendered):
            writers.append(write_pool.submit(
                _write_scene, config, setup, models, packed, body_R, body_t, event))
        dt = time.perf_counter() - t0
        n_real = len(setups)
        for setup in setups:
            stats.record(
                setup["scene_id"],
                frames=n_frames,
                seconds=dt / n_real,
                frames_per_s=n_frames * n_real / dt,
                splats=int(setup["template"].cloud.num_splats),
                n_objects=setup["n_obj"],
                env=setup["env"].object_name,
                object_ids=[int(o.ID) for o in setup["selected"]],
                binning_overflow_frames=0,
            )
        # the batch's stages, in seconds of the whole batch
        stats.batches.append(dict(scene_ids=list(batch_ids), t_setup=t_setup,
                                  t_physics=t_physics, t_render=t_render))

    from concurrent.futures import ThreadPoolExecutor

    write_pool = ThreadPoolExecutor(max_workers=2)
    writers = []
    try:
        for batch_start in range(0, len(scene_ids), n_dev):
            batch_ids = scene_ids[batch_start : batch_start + n_dev]
            # bounded retries per batch (a failed batch is re-randomized on
            # retry, like the sequential path's per-scene retry)
            retry_scene(lambda _sid: one_batch(batch_ids), batch_ids[0])
    finally:
        for fut in writers:
            fut.result()  # re-raises writer exceptions
        write_pool.shutdown(wait=True)
    print(f"[pegasus-tpu-torch] sharded generation summary: {stats.summary()}")
    return stats


def _write_scene(config, setup, models, packed, body_R, body_t, event=None):
    """Host-side BOP write of one scene from a lane's outputs, frame by
    frame through ``PEGASUS``'s frame record (``pegasus._write_frame``).
    Runs on the writer pool: it waits for the lane's copies (``event``)
    here, so that they overlap the next batch."""
    if event is not None:
        event.synchronize()
    packed = packed.numpy()
    body_R = body_R.numpy()
    body_t = body_t.numpy()
    n_obj = setup["n_obj"]
    engine = setup["engine"]

    # trajectory JSON (reference schema)
    engine._trajectory(setup["times_t"], setup["times_q"]).to_json(engine.trajectory_path)

    writer = BOPDatasetWriter(
        dataset_name=config.dataset_name,
        dataset_output_path=Path(config.dataset_base_path),
        camera_intr=setup["camera_intr"],
        render_width=config.render_width,
        render_height=config.render_height,
        object_models=models,
        scene_id=setup["scene_id"],
        unit_scale=config.unit_scale,
        write_models_now=False,
    )
    bullet_to_real = {
        bid: d.get("object_ID")
        for d in engine.asset_list["object"].values()
        for bid in d["bullet_id"]
    }
    objects = [(bid, bullet_to_real.get(bid, bid)) for bid in range(1, 1 + n_obj)]
    for i, cam_extr in enumerate(setup["cam_extr_np"]):
        planes = unpack_frame_bytes(packed[i], config.max_num_objects, palette=setup["colors"],
                                    with_depth_m=False)
        # K = max_num_objects picks the kernel's instance; the masks keep the scene's objects
        planes["mask_amodal"] = planes["mask_amodal"][..., :n_obj]
        planes["mask_visib"] = planes["mask_visib"][..., :n_obj]
        _write_frame(writer, i, planes, config.render_data_points, cam_extr, objects,
                     body_R[i], body_t[i])
    writer.save_scene_annotations()
    writer.close()
