"""Copied verbatim from ``pegasus_tpu/reconstruction/colmap_driver.py``; only the import lines differ.

COLMAP structure-from-motion driver (offline asset preparation).

Rebuild of the missing ``data_sfm_reconstruction.COLMAPReconstruction``
(contract: SURVEY 2.3.3, call sites at object_reconstruction.py:51-84,
spherical_object_reconstruction.py:116-129) and of the subprocess pattern
in the reference's convert script (reference: src/reconstruction/convert.py:35-78).

COLMAP stays an external executable (SURVEY 2.2: out of the hot path);
everything here shells out, caches completed stages, and reads results
back through pegasus_tpu_torch.io.colmap.  Image resizing uses Pillow instead of
ImageMagick (reference: convert.py:90-122).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np


class ColmapNotFoundError(RuntimeError):
    pass


class COLMAPReconstruction:
    def __init__(
        self,
        image_path,
        output_path,
        camera_model: str = "OPENCV",
        database_name: str = "database.db",
        resize: float | bool = False,
        single_camera: bool = True,
        gpu: bool = False,
        colmap_exe: str | None = None,  # default: $COLMAP_EXE or "colmap"
        magick_exe: str = "magick",  # accepted for API parity; Pillow is used
    ):
        self.image_path = Path(image_path)
        self.output_path = Path(output_path)
        self.camera_model = camera_model
        self.database_path = self.output_path / database_name
        self.sparse_path = self.output_path / "sparse"
        self.resize = resize
        self.single_camera = single_camera
        self.gpu = gpu
        self.colmap_exe = colmap_exe or os.environ.get("COLMAP_EXE", "colmap")
        self.output_path.mkdir(parents=True, exist_ok=True)
        self._stage_cache = self.output_path / "stages.json"

    # -- plumbing ---------------------------------------------------------------

    def _colmap_available(self) -> bool:
        return shutil.which(self.colmap_exe) is not None

    def _run(self, args: list, stage: str) -> None:
        """Run a colmap subcommand unless the stage is cached as done
        (the reference caches option JSONs to skip finished stages,
        colmap_wrapper/reconstruction/recunstruction.py:155-211)."""
        done = {}
        if self._stage_cache.exists():
            done = json.loads(self._stage_cache.read_text())
        if done.get(stage):
            return
        if not self._colmap_available():
            raise ColmapNotFoundError(
                f"'{self.colmap_exe}' not found on PATH; install COLMAP or "
                f"provide precomputed sparse models at {self.sparse_path}"
            )
        result = subprocess.run(
            [self.colmap_exe] + args, capture_output=True, text=True
        )
        if result.returncode != 0:
            raise RuntimeError(
                f"colmap {args[0]} failed ({result.returncode}):\n"
                + result.stderr[-4000:]
            )
        done[stage] = True
        self._stage_cache.write_text(json.dumps(done))

    def _resize_images(self) -> Path:
        if not self.resize:
            return self.image_path
        from PIL import Image

        factor = 0.5 if self.resize is True else float(self.resize)
        out = self.output_path / "images_resized"
        out.mkdir(parents=True, exist_ok=True)
        for p in sorted(self.image_path.iterdir()):
            if p.suffix.lower() not in (".jpg", ".jpeg", ".png"):
                continue
            dst = out / p.name
            if dst.exists():
                continue
            img = Image.open(p)
            img = img.resize(
                (int(img.width * factor), int(img.height * factor)),
                Image.LANCZOS,
            )
            img.save(dst)
        return out

    # -- the SfM pipeline (reference: convert.py:35-78) ---------------------------

    def run(
        self,
        reference_reconstruction: Optional[str] = None,
        image_list_path: Optional[str] = None,
        sparse_id: int = 0,
    ) -> Path:
        """feature_extractor -> matcher -> mapper (optionally pose-locked
        against a calibration-board reconstruction, SURVEY 2.3.3)."""
        images = self._resize_images()

        fe = [
            "feature_extractor",
            "--database_path", str(self.database_path),
            "--image_path", str(images),
            "--ImageReader.camera_model", self.camera_model,
            "--ImageReader.single_camera", "1" if self.single_camera else "0",
            "--SiftExtraction.use_gpu", "1" if self.gpu else "0",
        ]
        if image_list_path:
            fe += ["--image_list_path", str(image_list_path)]
        self._run(fe, "feature_extractor")

        self._run(
            [
                "exhaustive_matcher",
                "--database_path", str(self.database_path),
                "--SiftMatching.use_gpu", "1" if self.gpu else "0",
            ],
            "matcher",
        )

        out_sparse = self.sparse_path / str(sparse_id)
        out_sparse.mkdir(parents=True, exist_ok=True)
        if reference_reconstruction:
            # pose-locked mapping: triangulate against fixed calibration
            # poses, then bundle-adjust with poses constant
            self._run(
                [
                    "point_triangulator",
                    "--database_path", str(self.database_path),
                    "--image_path", str(images),
                    "--input_path", str(reference_reconstruction),
                    "--output_path", str(out_sparse),
                ],
                "point_triangulator",
            )
        else:
            self._run(
                [
                    "mapper",
                    "--database_path", str(self.database_path),
                    "--image_path", str(images),
                    "--output_path", str(self.sparse_path),
                ],
                "mapper",
            )
        return out_sparse

    def registrate_images_into_existing_model(
        self,
        database_path,
        working_dir_images,
        image_list_path,
        sparese_model_path,  # (sic) reference spelling preserved
        output_path,
        image_registration_mapper_settings: Optional[dict] = None,
    ) -> Path:
        """Register the flipped-object ('down') images into the 'up' model
        (contract: object_reconstruction.py:153-160)."""
        self._run(
            [
                "feature_extractor",
                "--database_path", str(database_path),
                "--image_path", str(working_dir_images),
                "--image_list_path", str(image_list_path),
                "--ImageReader.camera_model", self.camera_model,
                "--ImageReader.single_camera", "1",
            ],
            "register_features",
        )
        self._run(
            [
                "vocab_tree_matcher"
                if image_registration_mapper_settings
                and image_registration_mapper_settings.get("vocab_tree")
                else "exhaustive_matcher",
                "--database_path", str(database_path),
            ],
            "register_match",
        )
        args = [
            "image_registrator",
            "--database_path", str(database_path),
            "--input_path", str(sparese_model_path),
            "--output_path", str(output_path),
        ]
        for k, v in (image_registration_mapper_settings or {}).items():
            if k == "vocab_tree":
                continue
            args += [f"--Mapper.{k}", str(v)]
        self._run(args, "image_registrator")
        return Path(output_path)

    # -- metric scaling -------------------------------------------------------------

    def scale_scene(self, aruco_size: float, img_orig=None, visualize: bool = False,
                    sparse_id: int = 0, aruco_dict: str = "DICT_4X4_50") -> float:
        """Metric scale from ArUco markers: detect corners in registered
        images, cast rays through the camera poses, least-squares intersect,
        scale = marker_size / estimated side (reimplementation of the
        aruco-estimator submodule's method, SURVEY 2.5)."""
        from pegasus_tpu_torch.reconstruction.aruco_scale import estimate_aruco_scale

        sparse = self.sparse_path / str(sparse_id)
        scale = estimate_aruco_scale(
            sparse, self.image_path, aruco_size, aruco_dict=aruco_dict
        )
        self.scale_scene_by_const(scale, sparse_id=sparse_id)
        return scale

    def scale_scene_by_const(self, scale: float, sparse_id: int = 0) -> None:
        """Apply a similarity scale to the sparse model (tvecs + points)."""
        from pegasus_tpu_torch.io import colmap as cio

        sparse = self.sparse_path / str(sparse_id)
        images = cio.read_images_binary(sparse / "images.bin")
        for im in images.values():
            im.tvec = np.asarray(im.tvec) * scale
        cio.write_images_binary(images, sparse / "images.bin")
        pts_path = sparse / "points3D.bin"
        if pts_path.exists():
            pts = cio.read_points3d_binary(pts_path)
            for p in pts.values():
                p.xyz = np.asarray(p.xyz) * scale
            cio.write_points3d_binary(pts, pts_path)
