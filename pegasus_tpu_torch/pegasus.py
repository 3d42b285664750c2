"""PEGASUS orchestrator: physics -> composition -> render -> BOP export.

Port of ``pegasus_tpu/pegasus.py``: the same lifecycle ``init_bullet ->
init -> init_start_position -> generate_dataset -> save2bop`` and
constructor vocabulary, on one torch device.  ``init_bullet`` drops a scene
with the port's own engine (``physics/engine.py``); a scene can also replay
a trajectory JSON recorded by either engine (set ``physics_file`` and
``selected_env_name``, exactly as the reference allows).

The frame loop renders in chunks of ``frame_chunk`` frames (default 8, as
the reference's ``lax.map`` chunk programs): one projection, one binning
(one host read of the chunk's sizes) and one compositor launch render the
chunk's frames, which are encoded into one uint8 tensor on the device and
copied with ``non_blocking=True`` into a pinned host tensor of the chunk's
own.  Up to three chunks are in flight, as in the reference; the host
hands the oldest's frames to the BOP writer's thread pool and the video
worker while the device works on the newer ones.  The tensor comes from
PyTorch's caching host allocator, which reuses its block only when no view
of it is left, so a frame the pool or the video worker still holds is
never overwritten.  Two readback layouts (``ops/render.py``):

  * by default the chunk arrives writer-ready (``pack_writer_planes``):
    uint16 depth, rgb, the semantic image and one 0/255 plane per object
    mask, each a contiguous view that the writer and the video worker take
    as it is, so the issuing thread decodes no pixel between a chunk's
    readback and its hand-off;
  * ``compact_readback=True`` keeps the reference's RLE layout and its
    host decode: fewer bytes over the link (5 + ceil(2K/8) bytes a pixel
    and less, against 8 + 2K), for a link that is the bottleneck.

Static mode poses the scene once per scene, dynamic mode once per chunk (C
poses at once).  Every frame of a chunk has the bits it has in a chunk of
one, so the files do not depend on ``frame_chunk``.

Differences from the reference, all deliberate:
  * ``device`` (default "cuda") is explicit; without a CUDA device the
    default raises instead of falling back to the CPU;
  * exact tile binning cannot overflow, so ``last_render_stats`` has no
    ``binning_overflow_frames`` and there is no overflow warning;
  * preview videos (``VideoStreams``, which needs cv2) are built only when
    ``generate_dataset(save_video=True)``, and their frames are made and
    encoded on the streams' worker thread: the frame loop hands over the
    frame's rgb, depth_mm, semantic image, camera and object centres, and
    ``last_render_stats`` gets the streams' counters ``video_frames``,
    ``video_wait_s`` and (from ``save2bop``, which joins the worker)
    ``video_drain_s``;
  * the tail chunk is just shorter: nothing is compiled for a chunk size,
    so the reference's padding to a full chunk is not needed, and its
    ``readback_bytes`` counts no padding frames;
  * the default readback is writer-ready (above), where the reference
    moves its bit-packed frame and decodes it on the host; so
    ``last_render_stats`` counts ``writer_ready_frames`` (frames handed on
    without a host decode; 0 with ``compact_readback``), ``handoff_s``
    (from each chunk's readback to its last frame's hand-off) and
    ``slot_wait_s`` (getting each chunk's pinned host tensor and issuing
    its copy);
  * ``rasterize_fn=None`` renders with the forward kernel (``rasterize``,
    one launch per chunk; its plain version on the CPU), where the
    reference picks its Pallas kernel on TPU and its tiled renderer
    elsewhere.  A given ``rasterize_fn`` (``ops.rasterize_tiled``'s
    ``rasterize_tiled``, the golden ``rasterize_reference``, ...) renders
    every frame of every chunk, called as the reference calls it, with the
    port's own ``rasterize_kwargs`` added; the GUI renders with the same
    function;
  * ``publish2gui`` answers a pending SIBR viewer request once per chunk,
    as the reference does, with the chunk's last pose;
  * the GUI drops its connection on socket and protocol errors only: any
    other error, a failed kernel launch among them, propagates (the
    reference drops the connection on any exception);
  * ``enable_compilation_cache`` is the kernels' build cache
    (``utils/compile_cache.py``), not XLA's;
  * ``save2bop`` keeps the scene's gt-info records, computed by the BOP
    writer's pool from the masks it wrote, as ``last_gt_info``, so that
    ``run_generation`` writes scene_gt_info.json without reading the mask
    PNGs back;
  * posing runs under ``torch.profiler`` ranges named ``generate/pose``
    (static: once per scene; dynamic: once per scene around the pose
    sequence and once per chunk around its C poses), and
    ``generate_dataset`` counts it in ``last_pose_stats``: ``poses`` (the
    poses applied), ``posed_splats`` (splats written by them) and
    ``moving_splats`` (the object splats among those).
"""

from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Dict, List, Literal, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import CameraBatch
from pegasus_tpu_torch.device import resolve_device
from pegasus_tpu_torch.gs.ply import load_gs_ply
from pegasus_tpu_torch.io import colmap as colmap_io
from pegasus_tpu_torch.io.bop_writer import BOPDatasetWriter
from pegasus_tpu_torch.io.mesh import load_mesh
from pegasus_tpu_torch.physics.engine import MAX_BODIES, PhysicsEngine
from pegasus_tpu_torch.ops.render import (encode_frame, pack_writer_planes, palette_u8,
                                          render_chunk, render_frame, rle_max_runs,
                                          rle_pack_chunk, rle_unpack_chunk,
                                          split_frame_planes, writer_planes)
from pegasus_tpu_torch.scene.camera_trajectory import create_camera_trajectory
from pegasus_tpu_torch.scene.composition import (SceneTemplate, pose_scene,
                                                 poses_from_trajectory_step)
from pegasus_tpu_torch.scene.trajectory import Trajectory
from pegasus_tpu_torch.utils.compile_cache import enable_compilation_cache
from pegasus_tpu_torch.utils.colors import generate_colors


def _video_frame(rgb_u8, depth_mm, sem_u8, centers, K, cam_R, cam_t, colors) -> dict:
    """``VideoStreams``' keywords for one rendered frame, made on the video
    worker: the object-centre overlay, and the bytes that the reference's
    float arithmetic gives the depth and semantic streams.  The semantic
    image's round trip through floats in [0, 1] gives every byte back, so
    it goes as it is; depth's 8-bit plane is a lookup by millimetre."""
    from pegasus_tpu_torch.scene.video import depth_mm_to_u8, draw_object_centers

    return dict(
        rgb=rgb_u8, depth_u8=depth_mm_to_u8(depth_mm), seg_u8=sem_u8,
        center_image=draw_object_centers(rgb_u8, centers, K, cam_R, cam_t, colors),
    )


# -- one scene's steps, shared with the sharded generation (parallel/generation.py) --


def _draw_scene(rng, env_list, obj_list, min_num_objects, max_num_objects, *, asset_folder,
                dataset_dir, scene_id, simulation_steps, max_bodies, device):
    """The reference's draws from ``rng``, in its order: environment,
    object count, the choice of objects, the engine's seed, then one start
    position per object.  Returns (environment, chosen objects, the engine
    with their bodies added; its trajectory JSON goes under
    ``dataset_dir``/engine)."""
    min_num_objects = min(min_num_objects, len(obj_list))
    max_num_objects = min(max_num_objects, len(obj_list))
    env = env_list[int(rng.integers(0, len(env_list)))]
    n_objects = int(rng.integers(min_num_objects, max_num_objects + 1))
    selected = [obj_list[i] for i in rng.choice(len(obj_list), n_objects, replace=False).tolist()]
    engine = PhysicsEngine(
        asset_folder=asset_folder,
        output_path_json=str(Path(dataset_dir, "engine", f"{scene_id:06d}_simulation_steps.json")),
        simulation_steps=simulation_steps,
        seed=int(rng.integers(0, 2**31)),
        max_bodies=max_bodies,
        device=device,
    )
    engine.add_object(env, start_pos=env.START_POSITION_PYBULLET)
    for obj in selected:
        engine.add_object(obj, start_pos=env.define_start_pos(rng))
    return env, selected, engine


def _scene_cameras(env_entry: dict, settings, rng, device):
    """The camera trajectory over an environment's COLMAP poses
    (``env_entry``: its preload entry), with the render and trajectory
    settings of ``settings`` (a ``PEGASUS`` or a ``GenerationConfig``).
    Returns (cameras, the writer's ``camera_intr``, host copies of the
    extrinsics for scene_gt: one transfer per scene)."""
    cam_intr = env_entry["cam_intr"]
    first = cam_intr[min(cam_intr.keys())]
    fx, fy, _, _ = colmap_io.colmap_intrinsics(first)
    cams = create_camera_trajectory(
        cam_extr=env_entry["cam_extr"],
        focal_x=fx,
        intr_width=first.width,
        intr_height=first.height,
        render_width=settings.render_width,
        render_height=settings.render_height,
        num_cameras=settings.num_cameras,
        num_interpolation_steps=settings.num_camera_interpolation_steps,
        mode=settings.camera_trajectory_mode,
        rng=rng,
        device=device,
    )
    camera_intr = {"fx": fx, "fy": fy, "width": first.width, "height": first.height}
    return cams, camera_intr, [(c.R_w2c.cpu().numpy(), c.t_w2c.cpu().numpy()) for c in cams]


def _render_chunks(template, body_R, body_t, dynamic: bool, cams: CameraBatch, colors,
                   frame_chunk: int, background, rasterize_fn=None, rasterize_kwargs=None,
                   serve_gui=None):
    """A scene's frames in chunks of ``frame_chunk`` (the tail chunk just
    shorter): an iterator of (lo, hi, ``encode_frame`` of the chunk's
    ``render_chunk``).  Static: ``body_R`` [B, 3, 3], ``body_t`` [B, 3]
    pose the scene once, here at the call (inside the caller's
    ``generate/pose`` range, if any); dynamic: [F, B, ...], posed once per
    chunk (C poses at once) under a ``generate/pose`` range each.
    ``serve_gui``, if given, is called once per chunk with the posed scene
    (dynamic: its last pose).  The posed scene is not yielded: a caller's
    loop variable would keep a dynamic chunk's C posed clouds alive through
    the next chunk's render."""
    n_frames = len(cams)
    chunk = max(1, min(frame_chunk, n_frames))
    static_scene = None if dynamic else pose_scene(template, body_R, body_t)

    def chunks():
        scene = static_scene
        for lo in range(0, n_frames, chunk):
            hi = min(lo + chunk, n_frames)
            if dynamic:
                with record_function("generate/pose"):
                    scene = pose_scene(template, body_R[lo:hi], body_t[lo:hi])
            enc = encode_frame(render_chunk(
                scene, cams[lo:hi], colors, background=background,
                rasterize_fn=rasterize_fn, **(rasterize_kwargs or {}),
            ))
            if serve_gui is not None:
                serve_gui(scene.pose_frame(-1) if dynamic else scene)
            yield lo, hi, enc
    return chunks()


def _write_frame(writer: BOPDatasetWriter, i: int, planes: dict, data_points, cam_extr,
                 objects, gt_R, gt_t) -> None:
    """Frame ``i``'s BOP record from its ``planes`` (a frame of
    ``ops.render.writer_planes``' views or of ``unpack_frame_bytes``): its camera,
    the requested modalities (``rgb`` writes depth too, as the reference
    does), and its ground truth with ``cam_extr`` = (R, t) world-to-camera
    and, per (bullet id, object id) of ``objects``, the pose
    ``gt_R[bullet id]``, ``gt_t[bullet id]``."""
    writer.add_scene_camera(i)
    writer.write_training_data(
        frame_id=i,
        rgb=planes["rgb_u8"] if "rgb" in data_points else None,
        depth_mm=planes["depth_mm"] if ("depth" in data_points or "rgb" in data_points) else None,
        mask_amodal=planes["mask_amodal"] if "seg_sil" in data_points else None,
        mask_visib=planes["mask_visib"] if "seg_vis" in data_points else None,
        sem_mask=planes["sem_u8"] if "sem_seg" in data_points else None,
    )
    writer.add_scene_gt(
        frame_id=i,
        cam_R_w2c=cam_extr[0],
        cam_t_w2c=cam_extr[1],
        object_poses=[
            {"bullet_id": bid, "obj_id": obj_id, "R_init": gt_R[bid], "t_init": gt_t[bid]}
            for bid, obj_id in objects
        ],
    )


class PEGASUS:
    """End-to-end 6DoF pose dataset generator."""

    LOAD_ITERATION: int = 30_000
    SH_DEGREE: int = 3
    IP: str = "127.0.0.1"
    PORT: int = 6009

    def __init__(
        self,
        dataset_path: str,
        env_dataset_path: Optional[str],
        urdf_asset_folder: Union[str, list],
        gs_env_list: List[Asset],
        gs_object_list: List[Asset],
        mode: Literal["dynamic", "static"] = "static",
        camera_trajectory_mode: Literal["random", "sequence", "random+zoom"] = "random",
        render_height: int = 480,
        render_width: int = 640,
        num_cameras: int = 1,
        simulation_steps: int = 100,
        num_camera_interpolation_steps: int = 1,
        dataset_base_path: str = "./dataset",
        background=(0.0, 0.0, 0.0),
        seed: Optional[int] = None,
        splat_budget: Optional[int] = None,
        rasterize_fn=None,
        unit_scale: float = 1000.0,
        QUIET: bool = False,
        publish2gui: bool = False,  # serve frames to a SIBR viewer (TCP)
        frame_chunk: int = 8,  # frames per set of launches and per readback (1 = per frame)
        compact_readback: bool = False,
        freeze_dynamic_gt_pose: bool = False,  # reference quirk: dynamic
        # scene_gt keeps the t=0 pose for every frame
        device="cuda",
        rasterize_kwargs: Optional[dict] = None,  # more keywords for a given rasterize_fn
    ):
        # the kernels' build cache, where the reference enables XLA's
        enable_compilation_cache()
        self.rasterize_fn = rasterize_fn
        self.rasterize_kwargs = dict(rasterize_kwargs or {})
        self.frame_chunk = max(1, int(frame_chunk))
        self.compact_readback = compact_readback
        self.device = resolve_device(device)
        self.publish2gui = publish2gui
        if publish2gui:
            # SIBR remote-viewer socket, the reference's wire protocol
            from pegasus_tpu_torch import network_gui

            network_gui.init(self.IP, self.PORT)
        self.dataset_path = dataset_path
        self.env_dataset_path = env_dataset_path or dataset_path
        self.urdf_asset_folder = urdf_asset_folder
        self.render_height = render_height
        self.render_width = render_width
        self.num_cameras = num_cameras
        self.num_camera_interpolation_steps = num_camera_interpolation_steps
        self.simulation_steps = simulation_steps
        self.mode = mode
        self.camera_trajectory_mode = camera_trajectory_mode
        self.dataset_base_path = dataset_base_path
        self.background = background
        self.fps = 50
        self.rng = np.random.default_rng(seed)
        self.splat_budget = splat_budget
        self.unit_scale = unit_scale
        self.QUIET = QUIET
        self.freeze_dynamic_gt_pose = freeze_dynamic_gt_pose
        self.video = None

        # preload GS clouds (on the device) + COLMAP poses once
        self.gaussian_environment_pre_load: Dict[str, dict] = {}
        for env in gs_env_list:
            cloud = load_gs_ply(env.gaussian_point_cloud_path(self.LOAD_ITERATION), device=self.device)
            reco = Path(env.reconstruction_path)
            self.gaussian_environment_pre_load[env.object_name] = {
                "gs": cloud,
                "cam_extr": colmap_io.read_images_binary(reco / "sparse/0/images.bin"),
                "cam_intr": colmap_io.read_cameras_binary(reco / "sparse/0/cameras.bin"),
                "asset": env,
            }

        self.gaussian_object_pre_load: Dict[str, dict] = {}
        for obj in gs_object_list:
            obj.mode = "fused"
            cloud = load_gs_ply(obj.gaussian_point_cloud_path(self.LOAD_ITERATION), device=self.device)
            self.gaussian_object_pre_load[obj.object_name] = {"gs": cloud, "asset": obj}

        # object meshes for the BOP writer, loaded once
        self.object_meshes = {}
        for obj in gs_object_list:
            mesh_path = Path(obj.urdf_obj_path)
            if mesh_path.exists():
                self.object_meshes[obj.ID] = load_mesh(mesh_path)

    # -- physics -----------------------------------------------------------------

    def init_bullet(
        self,
        env_list: List[Asset],
        obj_list: List[Asset],
        dataset_name: str,
        scene_id: int,
        min_num_objects: int = 1,
        max_num_objects: int = 1,
        random: bool = True,
    ) -> None:
        """Drop a random object subset onto a random environment.  The
        draws from ``self.rng`` are the reference's, in its order:
        environment, object count, the choice of objects, the engine's
        seed, then one start position per object."""
        if not random:
            self.rng = np.random.default_rng(42)
        select_env, selected, engine = _draw_scene(
            self.rng, env_list, obj_list, min_num_objects, max_num_objects,
            asset_folder=self.urdf_asset_folder,
            dataset_dir=Path(self.dataset_base_path) / dataset_name,
            scene_id=scene_id,
            simulation_steps=self.simulation_steps,
            # auto-size the body capacity: rich scenes (30 objects) must
            # not hit the static default cap
            max_bodies=max(MAX_BODIES, min(max_num_objects, len(obj_list)) + 1),
            device=self.device,
        )
        self.selected_env_name = select_env.object_name
        self.selected_object_ids = [int(o.ID) for o in selected]
        self.trajectory = engine.simulate()
        self.physics_file = engine.trajectory_path
        self.py_engine = engine

    # -- per-scene setup -----------------------------------------------------------

    def init(self, dataset_name: str, scene_id: int) -> None:
        """Build the camera trajectory + BOP writer for one scene."""
        self.dataset_name = dataset_name
        self.scene_id = scene_id
        if not hasattr(self, "trajectory"):
            self.trajectory = Trajectory.from_json(self.physics_file)

        self.viewport_cam_list, camera_intr, self._cam_extr_np = _scene_cameras(
            self.gaussian_environment_pre_load[self.selected_env_name], self, self.rng, self.device
        )
        self.pegasus_dataset = BOPDatasetWriter(
            dataset_name=dataset_name,
            dataset_output_path=Path(self.dataset_base_path),
            camera_intr=camera_intr,
            render_width=self.render_width,
            render_height=self.render_height,
            object_models=self.object_meshes,
            scene_id=scene_id,
            unit_scale=self.unit_scale,
            collect_gt_info=True,  # save2bop hands the records on (last_gt_info)
        )

    # -- scene composition ------------------------------------------------------------

    def init_start_position(self) -> None:
        """Merge env + objects into the scene template."""
        traj = self.trajectory
        bullet_ids = traj.object_bullet_ids()
        id_to_asset = traj.bullet_id_to_asset()

        self.semantic_colors = generate_colors(len(bullet_ids), mode="rgb")
        self._semantic_colors_dev = torch.as_tensor(
            self.semantic_colors, dtype=torch.float32, device=self.device
        )

        env_cloud = self.gaussian_environment_pre_load[self.selected_env_name]["gs"]
        object_clouds = []
        self.bullet_to_real_id = {}
        for bid in bullet_ids:
            info = id_to_asset[bid]
            object_clouds.append(self.gaussian_object_pre_load[info.name]["gs"])
            self.bullet_to_real_id[bid] = info.object_ID

        self.template = SceneTemplate.build(env_cloud, object_clouds, pad_to=self.splat_budget)
        self._object_splats = sum(c.num_splats for c in object_clouds)
        self.bullet_ids = bullet_ids
        self._initial_step = 0 if self.mode == "dynamic" else traj.num_steps - 1

    def _body_poses_at(self, step):
        """Body poses at a timestep, or at each of a sequence of timesteps
        (one host-to-device copy); steps past the drop hold its last state."""
        step = np.minimum(step, self.trajectory.num_steps - 1)
        return poses_from_trajectory_step(
            self.trajectory.times_t, self.trajectory.times_q, step, device=self.device
        )

    def _serve_gui(self, scene) -> None:
        """Answer one pending SIBR viewer request with a render of the posed
        ``scene``, without blocking when none is pending (the reference's
        network_gui loop, pegasus.py:249-279).  A socket or protocol error
        drops the connection (a timeout mid-message too: the stream would
        be out of step); an error of the render propagates."""
        import select

        from pegasus_tpu_torch import network_gui as ng

        if ng.listener is None:
            return
        if ng.conn is None:
            ng.try_connect()
            if ng.conn is None:
                return
        try:
            # read only when a request is already pending
            readable, _, _ = select.select([ng.conn], [], [], 0.0)
            if not readable:
                return
            ng.conn.settimeout(2.0)
            cam = ng.receive(self.device)[0]
            ng.conn.settimeout(None)
        except ng.PROTOCOL_ERRORS:
            ng.conn = None
            return
        img_bytes = None
        if cam is not None:
            frame = render_frame(scene, cam, self._semantic_colors_dev, background=self.background,
                                 rasterize_fn=self.rasterize_fn, **self.rasterize_kwargs)
            img_bytes = ng.frame_bytes(frame.rgb)
        try:
            ng.send(img_bytes, self.dataset_path)
        except ng.PROTOCOL_ERRORS:
            ng.conn = None

    # -- main loop ------------------------------------------------------------------

    def _to_host(self, t: torch.Tensor):
        """Start the device->host copy of ``t`` into a host tensor of its
        own, pinned on the card; returns (host tensor, event that completes
        with it, or None on the CPU).  PyTorch's caching host allocator
        hands out a pinned block again only once no tensor or numpy view of
        it is left and its copy has completed, so the views that the writer
        pool and the video worker hold keep their chunk's bytes."""
        on_card = self.device.type == "cuda"
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card)
        host.copy_(t, non_blocking=on_card)
        if not on_card:
            return host, None
        event = torch.cuda.Event()
        event.record()
        return host, event

    def generate_dataset(
        self,
        data_points: List[str],
        save_bop: bool = True,
        save_video: bool = True,
    ) -> None:
        """Render the camera trajectory and write all requested modalities.

        Frames render in chunks of ``min(frame_chunk, frames)``: one set of
        launches, one host read (binning's sizes) and one readback per
        chunk, with up to ``DEPTH`` = 3 chunks in flight.  The tail chunk is
        just shorter (the reference pads it to a full chunk for its
        compiled program; eager torch compiles nothing).  The SIBR GUI is
        polled once per chunk."""
        import tqdm

        DEPTH = 3  # chunks in flight, as in the reference
        writer = self.pegasus_dataset
        n_frames = len(self.viewport_cam_list)
        n_objects = len(self.semantic_colors)
        if self.video is not None:  # left open by a scene that failed before save2bop
            video, self.video = self.video, None
            video.close()
        if save_video:
            from pegasus_tpu_torch.scene.video import VideoStreams

            self.video = VideoStreams(
                str(writer.video_path), self.render_width, self.render_height, fps=self.fps
            )
            pivots_np = self.template.pivots.cpu().numpy()

        cams = CameraBatch.stack(self.viewport_cam_list)
        dynamic = self.mode == "dynamic"
        with record_function("generate/pose"):  # dynamic: every frame's pose, one copy each way
            body_R, body_t = self._body_poses_at(
                self._initial_step + np.arange(n_frames) if dynamic else self._initial_step
            )
            chunks = _render_chunks(self.template, body_R, body_t, dynamic, cams,
                                    self._semantic_colors_dev, self.frame_chunk, self.background,
                                    self.rasterize_fn, self.rasterize_kwargs,
                                    self._serve_gui if self.publish2gui else None)
            poses_np = (body_R.cpu().numpy(), body_t.cpu().numpy())
        n_poses = n_frames if dynamic else 1
        self.last_pose_stats = {
            "poses": n_poses,
            "posed_splats": n_poses * self.template.cloud.num_splats,
            "moving_splats": n_poses * self._object_splats,
        }
        frozen_gt = (
            tuple(a.cpu().numpy() for a in self._body_poses_at(self._initial_step))
            if (dynamic and self.freeze_dynamic_gt_pose)
            else None
        )
        objects = [(bid, self.bullet_to_real_id.get(bid, bid)) for bid in self.bullet_ids]

        stats = {"readback_bytes": 0, "fetch_stall_s": 0.0, "rle_fallback_frames": 0,
                 "writer_ready_frames": 0, "handoff_s": 0.0, "slot_wait_s": 0.0}
        progress = tqdm.tqdm(total=n_frames, disable=self.QUIET)
        compact = self.compact_readback
        h, w = self.render_height, self.render_width
        n_planes = 1 + (2 * n_objects + 7) // 8
        colors_u8 = torch.as_tensor(palette_u8(self.semantic_colors, n_objects), device=self.device)

        def fetch_fallback(sparse_dev):
            stats["rle_fallback_frames"] += sparse_dev.shape[0]
            raw_sparse = sparse_dev.cpu().numpy()
            stats["readback_bytes"] += raw_sparse.nbytes
            return raw_sparse

        def write(lo, c, host, event, sparse_dev):
            t_wait = time.perf_counter()
            if event is not None:
                event.synchronize()
            t_ready = time.perf_counter()
            stats["fetch_stall_s"] += t_ready - t_wait
            raw = host.numpy()  # the planes below are views of the chunk's own host tensor
            stats["readback_bytes"] += raw.nbytes
            if compact:
                data = rle_unpack_chunk(
                    raw, (c, h, w), n_objects, rle_max_runs(c, h, w, n_planes),
                    palette=self.semantic_colors,
                    fallback_sparse=lambda: fetch_fallback(sparse_dev),
                    with_depth_m=False,
                )
            else:
                data = writer_planes(raw, h, w, n_objects)
                stats["writer_ready_frames"] += c
            for j in range(c):
                i = lo + j
                planes = {key: plane[j] for key, plane in data.items()}
                body_R_np, body_t_np = (poses_np[0][i], poses_np[1][i]) if dynamic else poses_np
                if save_bop:
                    gt_R, gt_t = frozen_gt if frozen_gt is not None else (body_R_np, body_t_np)
                    _write_frame(writer, i, planes, data_points, self._cam_extr_np[i], objects,
                                 gt_R, gt_t)
                else:
                    writer.add_scene_camera(i)
                if save_video:  # the video worker makes and encodes the frame
                    centers = (
                        np.stack([pivots_np[bid] + body_t_np[bid] for bid in self.bullet_ids])
                        if self.bullet_ids else np.zeros((0, 3))
                    )
                    self.video.submit(functools.partial(
                        _video_frame, planes["rgb_u8"], planes["depth_mm"], planes["sem_u8"],
                        centers, np.asarray(writer.K), *self._cam_extr_np[i], self.semantic_colors,
                    ))
                progress.update(1)
            stats["handoff_s"] += time.perf_counter() - t_ready

        pending = []
        for lo, hi, enc in chunks:
            sparse_dev = None
            if compact:
                dense, sparse = split_frame_planes(enc)
                packed, sparse_dev = rle_pack_chunk(
                    dense, sparse, rle_max_runs(hi - lo, h, w, n_planes)
                )
            else:
                packed = pack_writer_planes(enc, colors_u8)
            t_slot = time.perf_counter()
            host, event = self._to_host(packed)
            stats["slot_wait_s"] += time.perf_counter() - t_slot
            pending.append((lo, hi - lo, host, event, sparse_dev))
            if len(pending) == DEPTH:
                write(*pending.pop(0))  # overlaps the newer chunks' device work
        for args in pending:
            write(*args)
        progress.close()
        self.last_render_stats = {
            "readback_bytes": int(stats["readback_bytes"]),
            "fetch_stall_s": round(stats["fetch_stall_s"], 3),
            "writer_ready_frames": stats["writer_ready_frames"],
            "handoff_s": round(stats["handoff_s"], 4),
            "slot_wait_s": round(stats["slot_wait_s"], 4),
        }
        if compact:
            self.last_render_stats["rle_fallback_frames"] = stats["rle_fallback_frames"]
        if save_video:  # video_drain_s comes with save2bop's close
            self.last_render_stats.update(
                video_frames=self.video.frames, video_wait_s=round(self.video.wait_s, 4))

    def save2bop(self) -> None:
        """Finalize scene annotations.  The scene's gt-info records, taken
        from its masks in memory, stay as ``last_gt_info`` (scene_gt_info.json's
        content; ``generate.finalize_dataset(gt_info=)`` writes it)."""
        if self.video is not None:
            video, self.video = self.video, None
            video.close()
            self.last_render_stats["video_drain_s"] = round(video.drain_s, 4)
        writer = self.pegasus_dataset
        writer.save_scene_annotations()
        writer.close()
        self.last_gt_info = writer.scene_gt_info
        if not self.QUIET:
            print("Saved BOP data")
