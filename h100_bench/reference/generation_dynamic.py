"""The plain reference of one generated dynamic scene, from the same inputs.

A dynamic scene shows the drop as it happens: frame ``i`` of the camera
trajectory shows physics step ``min(i, T - 1)`` of the ``T``-step drop
(``PEGASUS(mode="dynamic")``, meyerls/PEGASUS pegasus.py:387-390, where
``PegasusSetup.update_object_pose`` moves each object by its step's pose
every frame).  This reference repeats ``reference.generation``'s seeded
draws of ``init_bullet`` in their order, the frozen drop op by op, the
camera trajectory, the scene template and the annotation rules of the BOP
writer; then, for every frame, the bodies' pose at that frame's step alone
(one ``poses_from_trajectory_step`` call a frame) for ``scene_gt``, and for
each sampled frame the template posed by that one pose
(``composition.pose_scene`` with a single pose, never several at once), the
plain render (projection, exact binning, ``composite_tiles_torch``), the
modality decode, the encode and pack of the frame bytes and their unpack on
the host.  It reads nothing the program made.

Where it departs from the source, as the port does by default:

* ``scene_gt`` holds each frame's own object poses.  The source writes the
  poses of the drop's first step into every frame's ground truth (the port
  keeps that as ``freeze_dynamic_gt_pose=True``, off by default);
* frames past the drop's last step hold its last state, where the source
  would read past the end of its trajectory.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from reference.generation import _gt_info


def frame_steps(n_frames: int, n_steps: int) -> list:
    """The physics step each frame of a dynamic scene shows."""
    return [min(i, n_steps - 1) for i in range(n_frames)]


def reference_dynamic_scene(root: Path, gen: dict, env_names, obj_names, scene_seed: int, frames,
                            device, workdir: Path) -> dict:
    """The dynamic scene's annotations (``scene_camera``, ``scene_gt`` of
    every frame) and the written images of ``frames``: {frame: {rgb, depth,
    mask, mask_visib, sem_mask}} as the PNGs hold them, and ``gt_info`` of
    those frames; with the template, the cameras and each frame's step."""
    from reference.frozen.assets.rosters import ENV_CLASSES, YCB_CLASSES
    from reference.frozen.camera import CameraBatch
    from reference.frozen.gs.ply import load_gs_ply
    from reference.frozen.io import colmap as colmap_io
    from reference.frozen.io.bop_writer import BOPDatasetWriter, _mask_bbox
    from reference.frozen.io.mesh import load_mesh
    from reference.frozen.ops.render import encode_frame, pack_frame_bytes, render_chunk, unpack_frame_bytes
    from reference.frozen.physics.engine import MAX_BODIES, PhysicsEngine
    from reference.frozen.scene import composition
    from reference.frozen.scene.camera_trajectory import create_camera_trajectory
    from reference.frozen.utils.colors import generate_colors

    if gen["mode"] != "dynamic":
        raise ValueError("this reference follows dynamic scenes; reference.generation the static ones")
    envs = [ENV_CLASSES[n](str(root)) for n in env_names]
    objs = [YCB_CLASSES[n](str(root)) for n in obj_names]
    rng = np.random.default_rng(scene_seed)
    workdir.mkdir(parents=True, exist_ok=True)

    # init_bullet: environment, object count, objects, engine seed, start positions
    lo = min(gen["min_num_objects"], len(objs))
    hi = min(gen["max_num_objects"], len(objs))
    env = envs[int(rng.integers(0, len(envs)))]
    n_objects = int(rng.integers(lo, hi + 1))
    selected = [objs[i] for i in rng.choice(len(objs), n_objects, replace=False).tolist()]
    engine = PhysicsEngine(
        asset_folder=gen.get("urdf_asset_folder") or str(Path(root) / "urdf"),
        output_path_json=str(workdir / "engine.json"),
        simulation_steps=gen["simulation_steps"],
        seed=int(rng.integers(0, 2**31)),
        max_bodies=max(MAX_BODIES, hi + 1),
        device=device,
    )
    engine.add_object(env, start_pos=env.START_POSITION_PYBULLET)
    for obj in selected:
        engine.add_object(obj, start_pos=env.define_start_pos(rng))
    traj = engine.simulate()

    # init: intrinsics, the annotation writer, the camera trajectory
    reco = Path(env.reconstruction_path)
    cam_extr = colmap_io.read_images_binary(reco / "sparse/0/images.bin")
    cam_intr = colmap_io.read_cameras_binary(reco / "sparse/0/cameras.bin")
    first = cam_intr[min(cam_intr.keys())]
    fx, fy, _, _ = colmap_io.colmap_intrinsics(first)
    w, h = gen["render_width"], gen["render_height"]
    models = {o.ID: load_mesh(o.urdf_obj_path) for o in objs if Path(o.urdf_obj_path).exists()}
    writer = BOPDatasetWriter(
        dataset_name="reference", dataset_output_path=workdir,
        camera_intr={"fx": fx, "fy": fy, "width": first.width, "height": first.height},
        render_width=w, render_height=h, object_models=models, scene_id=1,
        unit_scale=gen["unit_scale"], writer_threads=1, write_models_now=False,
    )
    cams = create_camera_trajectory(
        cam_extr=cam_extr, focal_x=fx, intr_width=first.width, intr_height=first.height,
        render_width=w, render_height=h, num_cameras=gen["num_cameras"],
        num_interpolation_steps=gen["num_camera_interpolation_steps"],
        mode=gen["camera_trajectory_mode"], rng=rng, device=device,
    )

    # init_start_position: the template of the environment and the dropped objects
    bullet_ids = traj.object_bullet_ids()
    id_to_asset = traj.bullet_id_to_asset()
    colors = generate_colors(len(bullet_ids), mode="rgb")
    by_name = {o.object_name: o for o in objs}
    env_cloud = load_gs_ply(env.gaussian_point_cloud_path(30_000), device=device)
    object_clouds = [load_gs_ply(by_name[id_to_asset[b].name].gaussian_point_cloud_path(30_000),
                                 device=device) for b in bullet_ids]
    real_id = {b: id_to_asset[b].object_ID for b in bullet_ids}
    template = composition.SceneTemplate.build(env_cloud, object_clouds)
    steps = frame_steps(len(cams), traj.num_steps)

    def pose_at(step: int):
        return composition.poses_from_trajectory_step(traj.times_t, traj.times_q, step, device=device)

    for i, cam in enumerate(cams):
        body_R, body_t = pose_at(steps[i])
        gt_R, gt_t = body_R.cpu().numpy(), body_t.cpu().numpy()
        writer.add_scene_camera(i)
        writer.add_scene_gt(i, cam.R_w2c.cpu().numpy(), cam.t_w2c.cpu().numpy(), [
            {"bullet_id": b, "obj_id": real_id.get(b, b), "R_init": gt_R[b], "t_init": gt_t[b]}
            for b in bullet_ids])
    writer.close()

    palette = torch.as_tensor(colors, dtype=torch.float32, device=device)
    images, gt_info = {}, {}
    with torch.no_grad():
        for f in frames:
            scene = composition.pose_scene(template, *pose_at(steps[f]))  # this frame's pose alone
            enc = encode_frame(render_chunk(scene, CameraBatch.stack([cams[f]]), palette,
                                            background=tuple(gen["background"])))
            data = unpack_frame_bytes(pack_frame_bytes(enc).cpu().numpy(), len(colors),
                                      palette=colors, with_depth_m=False)
            images[f] = {
                "rgb": data["rgb_u8"][0],
                "depth": data["depth_mm"][0],
                "mask": data["mask_amodal"][0],
                "mask_visib": data["mask_visib"][0],
                "sem_mask": data["sem_u8"][0],
            }
            gt_info[str(f)] = [_gt_info(images[f]["mask"][..., k], images[f]["mask_visib"][..., k],
                                        _mask_bbox) for k in range(len(colors))]
            del scene
    return {"scene_camera": writer.scene_camera_json, "scene_gt": writer.scene_gt_json,
            "images": images, "gt_info": gt_info, "n_objects": len(bullet_ids),
            "template": template, "cams": cams, "steps": steps, "palette": palette}
