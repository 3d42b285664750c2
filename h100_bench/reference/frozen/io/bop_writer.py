"""Frozen copy of pegasus_tpu_torch/io/bop_writer.py at commit 7a69f88, the annotation rules only: without the PNG writes and the NDDS conversion; cut to what the benchmark calls.

Copied verbatim from ``pegasus_tpu/io/bop_writer.py``; only the import lines differ, and ``calculate_gt_info`` reads its masks with ``io/png.py::read_png`` (no imageio).

BOP-format dataset writer (+ NDDS conversion, gt-info).

Functional equivalent of the reference's ``PegasusBOPDatasetWriter`` and
the module-level helpers of the missing ``src/dataset/data_writer.py``
(contract recovered from src/tools/pegasus_bop.py:300-587,
src/tools/pegasus_working.py:298-592, 926-954 and the call sites at
pegasus.py:136-143, 333-365, 392-396, 510-557).

Output tree (reference: pegasus_bop.py:312-346, pegasus_working.py:337-338):

    <out>/<dataset_name>/
      camera.json
      models/models_info.json, obj_{ID:06d}.ply
      train/<scene_id:06d>/{rgb,depth,mask,mask_visib,sem_mask}/
      train/<scene_id:06d>/scene_camera.json, scene_gt.json
      video/<scene_id:06d>/

Differences from the reference (all deliberate, documented):
  * object meshes are loaded once and cached — the reference re-reads each
    mesh from disk EVERY frame (pegasus_bop.py:464-466);
  * PNG writing goes through a bounded thread pool with a ``flush()`` join —
    the reference spawns unjoined daemon-ish threads per frame
    (pegasus.py:346-358) that can race process exit;
  * ``unit_scale`` converts model/gt translations to millimeters
    (BOP-standard).  The reference writes models/gt in meters but depth in
    millimeters; unit_scale=1.0 reproduces that behavior.
"""

from __future__ import annotations

import json
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from reference.frozen.io.mesh import TriMesh, save_mesh_ply
from reference.frozen.utils.pose import focal2fov, fov2focal


def _to_json(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


# NDDS corner ordering of open3d box points (reference diagram and reorder,
# src/tools/pegasus_bop.py:469-490): open3d indices -> NDDS order
_O3D_TO_NDDS = [0, 2, 5, 3, 1, 7, 4, 6]


class BOPDatasetWriter:
    """Accumulates one scene's annotations and writes the BOP tree."""

    def __init__(
        self,
        dataset_name: str,
        dataset_output_path,
        camera_intr: dict,
        render_width: int,
        render_height: int,
        object_models: Dict[int, TriMesh] | None,
        scene_id: int,
        unit_scale: float = 1000.0,
        writer_threads: int = 8,
        write_models_now: bool = True,
    ):
        """camera_intr: {'fx','fy','width','height'} of the source COLMAP
        reconstruction; rescaled to the render resolution through the
        fov2focal(focal2fov(...)) round trip the reference uses
        (pegasus_bop.py:348-366).

        object_models: {real_object_id: TriMesh in meters} (from the asset
        registry's URDF obj meshes).
        """
        self.dataset_name = dataset_name
        self.dataset_path = Path(dataset_output_path) / dataset_name
        self.scene_id = scene_id
        self.render_width = render_width
        self.render_height = render_height
        self.unit_scale = unit_scale
        self.object_models = dict(object_models or {})

        self.model_path = self.dataset_path / "models"
        self.train_data_path = self.dataset_path / "train"
        self.scene_path = self.train_data_path / f"{scene_id:06d}"
        self.rgb_path = self.scene_path / "rgb"
        self.depth_path = self.scene_path / "depth"
        self.mask_path = self.scene_path / "mask"
        self.mask_visib_path = self.scene_path / "mask_visib"
        self.sem_mask_path = self.scene_path / "sem_mask"
        self.video_path = self.dataset_path / "video" / f"{scene_id:06d}"
        for p in (
            self.model_path,
            self.rgb_path,
            self.depth_path,
            self.mask_path,
            self.mask_visib_path,
            self.sem_mask_path,
            self.video_path,
        ):
            p.mkdir(parents=True, exist_ok=True)

        # camera.json: intrinsics rescaled to render resolution
        fovx = focal2fov(camera_intr["fx"], camera_intr["width"])
        fovy = focal2fov(camera_intr["fy"], camera_intr["height"])
        self.camera_json = {
            "cx": render_width / 2,
            "cy": render_height / 2,
            "depth_scale": 1.0,  # uint16 depth is true millimeters
            "fx": fov2focal(fovx, render_width),
            "fy": fov2focal(fovy, render_height),
            "height": render_height,
            "width": render_width,
        }
        with open(self.dataset_path / "camera.json", "w") as f:
            json.dump(self.camera_json, f, indent=4, default=_to_json)

        self.K = np.array(
            [
                [self.camera_json["fx"], 0, self.camera_json["cx"]],
                [0, self.camera_json["fy"], self.camera_json["cy"]],
                [0, 0, 1.0],
            ]
        )

        if write_models_now and self.object_models:
            write_models(self.object_models, self.model_path, self.unit_scale)

        self.scene_camera_json: Dict[str, dict] = {}
        self.scene_gt_json: Dict[str, list] = {}
        self._pool = ThreadPoolExecutor(max_workers=writer_threads)
        self._futures: List[Future] = []

    # -- per-frame ------------------------------------------------------------

    def add_scene_camera(self, frame_id: int) -> None:
        self.scene_camera_json[str(frame_id)] = {
            "cam_K": [float(v) for v in self.K.flatten()],
            "depth_scale": 1.0,
        }

    def add_scene_gt(
        self,
        frame_id: int,
        cam_R_w2c: np.ndarray,
        cam_t_w2c: np.ndarray,
        object_poses: Sequence[dict],
    ) -> None:
        """object_poses: per visible object a dict with
        {'bullet_id': int, 'obj_id': int (real dataset id),
         'R_init': [3,3], 't_init': [3]} — the model-to-world pose.

        Emits the reference's gt record: cam_R_m2c / cam_t_m2c from
        T = T_w2c @ T_m2w plus the extras (T_w2c, T_m2w, NDDS-ordered OBB
        corners, projected corners/center)
        (reference: pegasus_bop.py:452-570, pegasus_working.py:565-576).
        """
        T_w2c = np.eye(4)
        T_w2c[:3, :3] = np.asarray(cam_R_w2c)
        T_w2c[:3, 3] = np.asarray(cam_t_w2c)

        entries = self.scene_gt_json.setdefault(str(frame_id), [])
        for op in object_poses:
            obj_id = int(op["obj_id"])
            mesh = self.object_models.get(obj_id)

            T_m2w = np.eye(4)
            T_m2w[:3, :3] = np.asarray(op["R_init"])
            T_m2w[:3, 3] = np.asarray(op["t_init"])
            T = T_w2c @ T_m2w

            entry = {
                "cam_R_m2c": [float(v) for v in T[:3, :3].flatten()],
                "cam_t_m2c": [float(v * self.unit_scale) for v in T[:3, 3]],
                "T_w2c": [float(v) for v in T_w2c.flatten()],
                "T_m2w": [float(v) for v in T_m2w.flatten()],
                "obj_id": obj_id,
                "bullet_obj_id": int(op["bullet_id"]),
            }

            if mesh is not None:
                corners = mesh.obb_corners()[_O3D_TO_NDDS]
                hom = np.ones((8, 4))
                hom[:, :3] = corners
                P = self.K @ T[:3]
                proj = (P @ hom.T).T
                proj = proj[:, :2] / proj[:, 2:3]
                center = mesh.get_center()
                chom = np.array([[*center, 1.0]])
                cproj = (P @ chom.T).T
                cproj = cproj[:, :2] / cproj[:, 2:3]
                entry.update(
                    {
                        "3d_bounding_box_model_coord": corners.tolist(),
                        "3d_bounding_center": center.tolist(),
                        "projected_center": cproj.tolist(),
                        "projected_points": proj.tolist(),
                    }
                )
            entries.append(entry)

    # -- finalize --------------------------------------------------------------

    def flush(self) -> None:
        for fut in self._futures:
            fut.result()  # re-raises worker exceptions
        self._futures.clear()


    def close(self) -> None:
        self.flush()
        self._pool.shutdown(wait=True)


# -- module-level helpers (data_writer.py contract, pegasus.py:408-409) --------


def write_models(
    object_models: Dict[int, TriMesh], model_path, unit_scale: float = 1000.0
) -> dict:
    """models_info.json + obj_{ID:06d}.ply keyed by REAL object ids
    (reference: pegasus_working.py:926-954; mm scaling per
    object_visualization.py:439-445)."""
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    info = {}
    for obj_id, mesh in sorted(object_models.items()):
        scaled = mesh.scaled(unit_scale)
        lo, hi = scaled.aabb()
        info[str(obj_id)] = {
            "diameter": scaled.diameter(),
            "min_x": lo[0],
            "min_y": lo[1],
            "min_z": lo[2],
            "size_x": hi[0] - lo[0],
            "size_y": hi[1] - lo[1],
            "size_z": hi[2] - lo[2],
        }
        save_mesh_ply(scaled, model_path / f"obj_{obj_id:06d}.ply", ascii=True)
    with open(model_path / "models_info.json", "w") as f:
        json.dump(info, f, indent=1, default=_to_json)
    return info


def _mask_bbox(mask: np.ndarray) -> list:
    """[x, y, w, h] of the tight bbox, BOP convention; [-1]*4 if empty."""
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return [-1, -1, -1, -1]
    return [
        int(xs.min()),
        int(ys.min()),
        int(xs.max() - xs.min() + 1),
        int(ys.max() - ys.min() + 1),
    ]


