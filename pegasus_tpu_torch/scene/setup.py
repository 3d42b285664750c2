"""``PegasusSetup`` facade: per-scene state with the reference's surface.

Port of ``pegasus_tpu/scene/setup.py``: the same host logic; cameras,
object clouds and pose arithmetic live on ``device`` (the card by
default), and the poses handed to the GaussianModels are host arrays, as
in the JAX package.

Compatibility layer over the functional scene modules for code written
against the reference's PegasusSetup (reference:
src/gs/pegasus_setup.py:40-306).  Loads the physics trajectory JSON,
resolves the environment asset by class name, builds interpolated camera
trajectories, poses objects for static/dynamic scenes, and manages the
preview video streams.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal

import numpy as np
import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pegasus_tpu_torch.scene.camera_trajectory import create_camera_trajectory
from pegasus_tpu_torch.scene.trajectory import Trajectory
from pegasus_tpu_torch.scene.video import VideoStreams, draw_object_centers
from pegasus_tpu_torch.utils import quaternion as quat


class PegasusSetup:
    def __init__(
        self,
        pybullet_trajectory_path,
        dataset_path,
        render_height: int,
        render_width: int,
        env_dataset_path=None,
        mode: Literal["dynamic", "static"] = "static",
        asset_registry=None,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.pybullet_trajectory_path = pybullet_trajectory_path
        self.trajectory = Trajectory.from_json(pybullet_trajectory_path)
        self.dataset_path = dataset_path
        self.env_dataset_path = env_dataset_path or dataset_path
        self.render_height = render_height
        self.render_width = render_width
        self.mode = mode

        self.environment_name = self.trajectory.environment.name
        self.environment_class_name = self.trajectory.environment.class_name
        if asset_registry is None:
            from pegasus_tpu_torch.assets.rosters import full_registry

            asset_registry = full_registry(
                dataset_path, env_dataset_path=self.env_dataset_path
            )
        self.environment = asset_registry.by_class_name(
            self.environment_class_name
        )
        self.object_data = {
            name: {
                "bullet_id": info.bullet_ids,
                "class_name": info.class_name,
                "object_ID": info.object_ID,
            }
            for name, info in self.trajectory.objects.items()
        }
        self.object_trajectory = self.trajectory
        self.registry = asset_registry
        # populated externally like the reference does (pegasus.py:132-133)
        self.cam_extr = None
        self.cam_intr = None
        self.video = None

    # -- cameras (reference: pegasus_setup.py:85-143) -----------------------------

    def create_camera_trajectory(
        self,
        num_cameras: int = 5,
        num_interpolation_steps: int = 24,
        mode: Literal["random", "sequence", "random+zoom"] = "random",
        rng=None,
    ):
        from pegasus_tpu_torch.io.colmap import colmap_intrinsics

        intr = self.cam_intr[min(self.cam_intr.keys())]
        fx, _, _, _ = colmap_intrinsics(intr)
        return create_camera_trajectory(
            cam_extr=self.cam_extr,
            focal_x=fx,
            intr_width=intr.width,
            intr_height=intr.height,
            render_width=self.render_width,
            render_height=self.render_height,
            num_cameras=num_cameras,
            num_interpolation_steps=num_interpolation_steps,
            mode=mode,
            rng=rng,
            device=self.device,
        )

    # -- object posing (reference: pegasus_setup.py:160-226) ------------------------

    def load_object_gs(self, sh_degree: int = 3, load_iteration: int = 30_000):
        """{bullet_id: GaussianModel} like the reference
        (pegasus_setup.py:145-158)."""
        from pegasus_tpu_torch.gs.model import GaussianModel

        out = {}
        for name, info in self.trajectory.objects.items():
            asset = self.registry.by_class_name(info.class_name)
            asset.mode = "fused"
            for bid in info.bullet_ids:
                gs = GaussianModel(sh_degree, device=self.device).load_ply(
                    asset.gaussian_point_cloud_path(load_iteration)
                )
                gs.meta_info = asset
                out[bid] = gs
        return out

    def _pose_at(self, bullet_id: int, step: int):
        t, q_xyzw = self.trajectory.pose_at(bullet_id, step)
        q = quat.xyzw_to_wxyz(self._f32(q_xyzw))
        return quat.quat_to_rotmat(q).cpu().numpy(), np.asarray(t, np.float32)

    def static_object_pose(self, gaussians_object_list: dict) -> dict:
        """Pose every object at the LAST physics timestep
        (reference: pegasus_setup.py:209-226)."""
        self.mode = "static"
        last = self.trajectory.num_steps - 1
        for bid, gs in gaussians_object_list.items():
            R, t = self._pose_at(bid, last)
            gs.R_init, gs.t_init = R, t
            self.apply_transformation_on_gs(gs, R, t)
        return gaussians_object_list

    def dynamic_object_pose(self, gaussians_object_list: dict) -> dict:
        """Pose every object at timestep 0 (reference:
        pegasus_setup.py:160-176)."""
        self.mode = "dynamic"
        for bid, gs in gaussians_object_list.items():
            R, t = self._pose_at(bid, 0)
            gs.R_init, gs.t_init = R, t
            self.apply_transformation_on_gs(gs, R, t)
        return gaussians_object_list

    def update_object_pose(self, gaussians_object_list: dict, timestep: int) -> dict:
        """Advance to `timestep` by the delta pose
        q_delta = q_t * q_{t-1}^-1 (reference: pegasus_setup.py:178-193)."""
        for bid, gs in gaussians_object_list.items():
            t1, q1 = self.trajectory.pose_at(bid, timestep)
            t0, q0 = self.trajectory.pose_at(bid, timestep - 1)
            qa = quat.xyzw_to_wxyz(self._f32(q1))
            qb = quat.xyzw_to_wxyz(self._f32(q0))
            q_delta = quat.quat_mul(qa, quat.quat_conjugate(quat.normalize(qb)))
            R = quat.quat_to_rotmat(q_delta).cpu().numpy()
            self.apply_transformation_on_gs(
                gs, R, np.asarray(t1) - np.asarray(t0)
            )
        return gaussians_object_list

    def apply_transformation_on_gs(self, gs_object, R, t) -> None:
        """xyz + per-splat quats + SH in one composite
        (reference: pegasus_setup.py:195-207)."""
        T = np.eye(4)
        T[:3, :3] = np.asarray(R)
        T[:3, 3] = np.asarray(t)
        gs_object.center_position = np.asarray(t)
        gs_object.rotation_matrix = np.asarray(R)
        gs_object.transformation_matrix = T
        gs_object.apply_transformation(T)

    # -- video (reference: pegasus_setup.py:262-306) ---------------------------------

    def init_video_streams(self, output: str = "./output", fps: int = 10) -> None:
        self.video = VideoStreams(
            output, self.render_width, self.render_height, fps=fps
        )

    def close_video_streams(self) -> None:
        if self.video:
            self.video.close()

    def write_image2video(self, rgb, depth, seg, center_image,
                          max_distance_in_meter: float = 5.0) -> None:
        host = lambda x: None if x is None else (
            x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
        self.video.write_frame(
            rgb=rgb, depth=host(depth),
            seg=host(seg),
            center_image=center_image,
            max_distance_in_meter=max_distance_in_meter,
        )

    def draw_object_center(self, image, gaussians_object_list, camera: Camera,
                           semantic_colors, K) -> np.ndarray:
        """Debug overlay (reference: pegasus_setup.py:228-260)."""
        centers = np.stack(
            [gs.cloud.centroid().cpu().numpy() for gs in gaussians_object_list.values()]
        )
        host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return draw_object_centers(
            image, centers, host(K), host(camera.R_w2c), host(camera.t_w2c),
            host(semantic_colors),
        )

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @staticmethod
    def load_json(file):
        import json

        with open(file) as f:
            return json.load(f)
