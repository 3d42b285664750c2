"""Port of ``pegasus_tpu/io/bop_writer.py``: ``calculate_gt_info`` reads its masks with ``io/png.py::read_png`` (no imageio), and a writer made with ``collect_gt_info=True`` derives each frame's gt-info records from the masks it writes.

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
    millimeters; unit_scale=1.0 reproduces that behavior;
  * ``collect_gt_info=True`` (the owner hands the records on, as
    ``PEGASUS.save2bop`` does) computes scene_gt_info's records in the pool
    from the masks as they are written, so nothing decodes the PNGs again.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from pegasus_tpu_torch.io.mesh import TriMesh, load_mesh, save_mesh_ply
from pegasus_tpu_torch.utils.pose import focal2fov, fov2focal


def _to_json(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


from pegasus_tpu_torch.io.png import write_png  # native zlib encoder, GIL-free


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
        collect_gt_info: bool = False,
    ):
        """camera_intr: {'fx','fy','width','height'} of the source COLMAP
        reconstruction; rescaled to the render resolution through the
        fov2focal(focal2fov(...)) round trip the reference uses
        (pegasus_bop.py:348-366).

        object_models: {real_object_id: TriMesh in meters} (from the asset
        registry's URDF obj meshes).

        collect_gt_info: derive each frame's gt-info from its masks in the
        pool; ``save_scene_annotations`` then sets ``scene_gt_info`` to
        what ``calculate_gt_info`` would read back from the PNGs.
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
        # frame id -> (amodal, visib) per-channel (pixel count, bbox), None
        # for a modality not written; filled by the pool's jobs
        self._mask_stats: Dict[int, tuple] | None = {} if collect_gt_info else None
        self.scene_gt_info: Dict[str, list] | None = None

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

    def write_training_data(
        self,
        frame_id: int,
        rgb: np.ndarray | None = None,  # [H,W,3] uint8
        depth_m: np.ndarray | None = None,  # [H,W] float meters
        mask_amodal: np.ndarray | None = None,  # [H,W,K] bool, or [K,H,W] uint8 0/255
        mask_visib: np.ndarray | None = None,  # [H,W,K] bool, or [K,H,W] uint8 0/255
        sem_mask: np.ndarray | None = None,  # [H,W,3] uint8
        depth_mm: np.ndarray | None = None,  # [H,W] uint16 (pre-encoded)
        asynchronous: bool = True,
    ) -> None:
        """Write one frame's images.  Depth goes out as uint16 millimeters
        (reference: pegasus.py:355); per-object masks as binary PNGs named
        {frame:06d}_{channel:06d}.png (reference: pegasus_bop.py:426-434).
        Masks come as [H, W, K] (bool, or any dtype with nonzero = set) or,
        writer-ready, as uint8 0/255 planes [K, H, W] at the render size,
        which are written as they are."""

        def _mask_u8(m):
            # bool -> 0/255 with ONE temporary (dtype view is free);
            # non-bool inputs keep the copying path
            if m.dtype == np.bool_:
                return m.view(np.uint8) * np.uint8(255)
            return m.astype(np.uint8) * np.uint8(255)

        def write_masks(path, masks):
            """One PNG per channel; with gt-info collected, each channel's
            (pixel count, bbox) of the plane as a PNG reader sees it (> 127)."""
            ready = masks.dtype == np.uint8 and masks.shape[1:] == (self.render_height,
                                                                    self.render_width)
            stats = []
            for k in range(masks.shape[0] if ready else masks.shape[-1]):
                plane = masks[k] if ready else _mask_u8(masks[..., k])
                write_png(path / f"{frame_id:06d}_{k:06d}.png", plane, compression=1)
                if self._mask_stats is not None:
                    stats.append(_plane_stats(plane if ready or masks.dtype == np.bool_
                                              else plane > 127))
            return stats

        # per-modality deflate levels, tuned for single-core hosts (the
        # writer is the generation wall-clock bottleneck there): masks and
        # sem are mostly-zero byte planes where level 1 is 2-3x faster at
        # nearly the same size; 16-bit depth saves ~5 ms/frame at level 1
        # for ~5% size; rendered rgb is texture-dense, where deflate cost
        # is level-insensitive — level 2 is never slower.
        def job():
            if rgb is not None:
                write_png(self.rgb_path / f"{frame_id:06d}.png", rgb,
                          compression=2)
            if depth_mm is not None:
                write_png(self.depth_path / f"{frame_id:06d}.png", depth_mm,
                          compression=1)
            elif depth_m is not None:
                d16 = np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16)
                write_png(self.depth_path / f"{frame_id:06d}.png", d16,
                          compression=1)
            amodal = None if mask_amodal is None else write_masks(self.mask_path, mask_amodal)
            visib = None if mask_visib is None else write_masks(self.mask_visib_path, mask_visib)
            if self._mask_stats is not None:
                self._mask_stats[frame_id] = (amodal, visib)
            if sem_mask is not None:
                write_png(self.sem_mask_path / f"{frame_id:06d}.png",
                          sem_mask, compression=1)

        if asynchronous:
            self._futures.append(self._pool.submit(job))
        else:
            job()

    # -- finalize --------------------------------------------------------------

    def flush(self) -> None:
        for fut in self._futures:
            fut.result()  # re-raises worker exceptions
        self._futures.clear()

    def save_scene_annotations(self) -> None:
        """scene_camera.json + scene_gt.json (reference save2bop,
        pegasus.py:392-396); with gt-info collected, ``scene_gt_info`` in
        scene_gt's frame order, one record per gt entry."""
        self.flush()
        if self._mask_stats is not None:
            def channel(stats, k):
                return stats[k] if stats is not None and k < len(stats) else None

            self.scene_gt_info = {}
            for frame_id, entries in self.scene_gt_json.items():
                amodal, visib = self._mask_stats.get(int(frame_id), (None, None))
                self.scene_gt_info[frame_id] = [
                    _gt_record(channel(amodal, k), channel(visib, k)) for k in range(len(entries))
                ]
        with open(self.scene_path / "scene_camera.json", "w") as f:
            json.dump(self.scene_camera_json, f, indent=1, default=_to_json)
        with open(self.scene_path / "scene_gt.json", "w") as f:
            json.dump(self.scene_gt_json, f, indent=1, default=_to_json)

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


def calculate_gt_info(dataset_root, dataset_name=None, scene_ids=None, object_list=None) -> None:
    """scene_gt_info.json per scene: bbox_obj/bbox_visib/px counts/
    visib_fract from the written mask PNGs (schema per bop_toolkit
    scripts/calc_gt_info.py).

    Two call shapes are accepted:
      * ``calculate_gt_info(dataset_root, dataset_name, scene_ids)`` —
        explicit paths (this package's native form);
      * ``calculate_gt_info(dataset_name, num_scenes, object_list)`` —
        the reference's signature (reference: pegasus.py:536), where the
        dataset root comes from the ``PEGASUS_PATH`` environment variable
        (reference: pegasus.py:407) and scenes are 1..num_scenes.
    """
    from pegasus_tpu_torch.io.png import read_png

    if isinstance(dataset_name, int):
        # reference call shape: (dataset_name, num_scenes, object_list)
        num_scenes = dataset_name
        dataset_name = str(dataset_root)
        dataset_root = os.environ.get("PEGASUS_PATH", ".")
        scene_ids = range(1, num_scenes + 1)

    for scene_id in scene_ids:
        scene_path = Path(dataset_root) / dataset_name / "train" / f"{scene_id:06d}"
        gt_path = scene_path / "scene_gt.json"
        if not gt_path.exists():
            continue
        with open(gt_path) as f:
            scene_gt = json.load(f)
        info = {}
        for frame_id, entries in scene_gt.items():
            fid = int(frame_id)
            frame_info = []
            for k in range(len(entries)):
                amodal_p = scene_path / "mask" / f"{fid:06d}_{k:06d}.png"
                visib_p = scene_path / "mask_visib" / f"{fid:06d}_{k:06d}.png"
                amodal = visib = None
                if amodal_p.exists():
                    am = np.asarray(read_png(amodal_p)) > 127
                    amodal = (int(am.sum()), _mask_bbox(am))
                if visib_p.exists():
                    vis = np.asarray(read_png(visib_p)) > 127
                    visib = (int(vis.sum()), _mask_bbox(vis))
                frame_info.append(_gt_record(amodal, visib))
            info[frame_id] = frame_info
        write_scene_gt_info(scene_path, info)


def write_scene_gt_info(scene_path, info: dict) -> None:
    """scene_gt_info.json of one scene: {frame id: [record per gt entry]}."""
    with open(Path(scene_path) / "scene_gt_info.json", "w") as f:
        json.dump(info, f, indent=1, default=_to_json)


def _gt_record(amodal, visib) -> dict:
    """One object's gt-info record from its amodal and visible masks'
    (pixel count, bbox), each None where that mask was not written."""
    rec = {
        "bbox_obj": [-1, -1, -1, -1],
        "bbox_visib": [-1, -1, -1, -1],
        "px_count_all": 0,
        "px_count_valid": 0,
        "px_count_visib": 0,
        "visib_fract": 0.0,
    }
    if amodal is not None:
        rec["px_count_all"] = rec["px_count_valid"] = amodal[0]
        rec["bbox_obj"] = amodal[1]
    if visib is not None:
        rec["px_count_visib"], rec["bbox_visib"] = visib
    if rec["px_count_all"] > 0:
        rec["visib_fract"] = rec["px_count_visib"] / rec["px_count_all"]
    return rec


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


def _plane_stats(hit: np.ndarray) -> tuple:
    """(pixel count, ``_mask_bbox``) of a contiguous 2-D uint8 or bool mask
    plane, nonzero = set.  Rows and columns are OR-reduced as 8-byte words
    where the width allows (a word is nonzero where one of its bytes is, and
    OR keeps each byte's column), and pixels are counted on the rows hit
    alone: numpy loops that release the GIL, which the pool's deflates share."""
    words = hit.view(np.uint64) if hit.shape[1] % 8 == 0 else hit
    ys = np.flatnonzero(np.bitwise_or.reduce(words, axis=1))
    if len(ys) == 0:
        return 0, [-1, -1, -1, -1]
    y0, y1 = int(ys[0]), int(ys[-1])
    xs = np.flatnonzero(np.bitwise_or.reduce(words[y0:y1 + 1], axis=0).view(np.uint8))
    n = int(np.count_nonzero(hit[y0:y1 + 1]))
    return n, [int(xs[0]), y0, int(xs[-1] - xs[0] + 1), y1 - y0 + 1]


def convert_scenewise_to_imagewise_ndds(
    input_path, output_path, scene_ids_process: str
) -> None:
    """Re-layout BOP scene-wise data into an NDDS-style image-wise folder
    (contract: pegasus.py:546-557 — the implementation lived in the missing
    data_writer.py; this is a faithful reconstruction of the observable
    contract: sequentially renumbered frames, one json per image with
    camera + per-object pose/bbox data, 80/20 split driven by the caller's
    scene id string "1,2,3,...")."""
    input_path = Path(input_path)
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    scene_ids = [int(s) for s in str(scene_ids_process).split(",") if s != ""]

    idx = 0
    camera_settings_written = False
    for scene_id in scene_ids:
        scene_path = input_path / f"{scene_id:06d}"
        if not scene_path.exists():
            continue
        with open(scene_path / "scene_gt.json") as f:
            scene_gt = json.load(f)
        with open(scene_path / "scene_camera.json") as f:
            scene_cam = json.load(f)

        if not camera_settings_written and scene_cam:
            first = next(iter(scene_cam.values()))
            K = np.asarray(first["cam_K"]).reshape(3, 3)
            with open(output_path / "_camera_settings.json", "w") as f:
                json.dump(
                    {
                        "camera_settings": [
                            {
                                "name": "viewpoint",
                                "intrinsic_settings": {
                                    "fx": K[0, 0],
                                    "fy": K[1, 1],
                                    "cx": K[0, 2],
                                    "cy": K[1, 2],
                                    "s": 0,
                                },
                            }
                        ]
                    },
                    f,
                    indent=1,
                    default=_to_json,
                )
            camera_settings_written = True

        frame_ids = sorted(int(k) for k in scene_gt.keys())
        for fid in frame_ids:
            src_rgb = scene_path / "rgb" / f"{fid:06d}.png"
            if not src_rgb.exists():
                continue
            shutil.copyfile(src_rgb, output_path / f"{idx:06d}.png")
            src_depth = scene_path / "depth" / f"{fid:06d}.png"
            if src_depth.exists():
                shutil.copyfile(src_depth, output_path / f"{idx:06d}.depth.png")

            objects = []
            for entry in scene_gt[str(fid)]:
                obj = {
                    "class": str(entry.get("obj_id")),
                    "location": entry.get("cam_t_m2c"),
                    "pose_transform_permuted": entry.get("cam_R_m2c"),
                }
                if "projected_points" in entry:
                    obj["projected_cuboid"] = entry["projected_points"]
                    obj["projected_cuboid_centroid"] = entry["projected_center"]
                objects.append(obj)
            with open(output_path / f"{idx:06d}.json", "w") as f:
                json.dump(
                    {
                        "camera_data": scene_cam.get(str(fid), {}),
                        "objects": objects,
                    },
                    f,
                    indent=1,
                    default=_to_json,
                )
            idx += 1
