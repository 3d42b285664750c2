"""Copied verbatim from ``pegasus_tpu/reconstruction/pycolmap_driver.py``; only the import lines differ.

In-process COLMAP driver over the pycolmap bindings (offline prep).

Rebuild of colmap-wrapper's in-process reconstruction path (reference:
submodules/colmap-wrapper/colmap_wrapper/reconstruction/recunstruction.py:212-341
and camera_config.py): the same stage sequence — feature extraction →
matching → incremental mapping → undistortion → patch-match stereo →
stereo fusion — executed through the pycolmap C++ bindings instead of a
``colmap`` subprocess, with the reference's option-stamp stage cache
(each stage writes its option dict to ``options/<stage>.json`` and is
skipped when the stamp matches).

pycolmap is optional (SURVEY 2.2 marks SfM external/offline): the module
imports lazily and ``available()`` reports whether the bindings exist.
Tests drive the full pipeline through a stub module injected via the
``backend=`` parameter, so the driver's orchestration (multi-project
layout, stage cache, option plumbing) is covered without the binary
dependency; on a machine with pycolmap installed the same code runs the
real pipeline.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


class PycolmapNotFoundError(RuntimeError):
    pass


def _import_pycolmap():
    try:
        import pycolmap  # type: ignore

        return pycolmap
    except ModuleNotFoundError:
        return None


def available() -> bool:
    """True when the pycolmap bindings are importable."""
    return _import_pycolmap() is not None


@dataclass
class CameraConfig:
    """Camera prior handed to the mapper (reference: camera_config.py).

    The reference wraps a ``pycolmap.Camera``; here the config is a plain
    dataclass resolved against the backend at run time, so configs can be
    constructed (and tested) without the bindings.
    """

    model: str = "SIMPLE_PINHOLE"
    width: int = 3200
    height: int = 3200
    params: tuple = ()

    def to_camera(self, backend):
        return backend.Camera(
            model=self.model,
            width=self.width,
            height=self.height,
            params=list(self.params),
        )


# The reference's three presets (camera_config.py:28-72).
UNKNOWN_CAMERA = CameraConfig("SIMPLE_PINHOLE", 3200, 3200, ())
P1_CAMERA = CameraConfig("SIMPLE_PINHOLE", 8192, 5460, ())
DSLR_CAMERA = CameraConfig(
    "OPENCV", 6000, 4000,
    (4518.9, 4511.7, 3032.2, 2020.9, -0.1623, 0.0902, 0.0, 0.0),
)

_IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".ppm"}


@dataclass
class InProcessReconstruction:
    """pycolmap-backed reconstruction with the reference's project layout.

    ``images`` may point at a folder of images (one project) or at a
    folder of folders (one project per subfolder, like the reference's
    multi-project loop, recunstruction.py:72-110).  Each project gets
    ``{output}/{idx}/ {database.db, sparse/, dense/, options/}``.
    """

    images: str | Path
    output: str | Path
    camera: CameraConfig = field(default_factory=lambda: UNKNOWN_CAMERA)
    matching: str = "exhaustive"  # 'exhaustive' | 'spatial'
    patch_match_max_image_size: int = 4000
    stereo_fusion_max_image_size: int = 4000
    dense: bool = True
    backend: object = None  # injected pycolmap-compatible module

    def __post_init__(self):
        if self.backend is None:
            self.backend = _import_pycolmap()
        if self.matching not in ("exhaustive", "spatial"):
            raise ValueError(f"unknown matching mode: {self.matching}")
        self.images = Path(self.images).expanduser().resolve()
        root = Path(self.output).expanduser().resolve()
        has_images = any(
            p.suffix.lower() in _IMAGE_SUFFIXES for p in self.images.glob("*")
        )
        self.projects = {}
        if has_images:
            folders = {0: self.images}
        else:
            folders = {
                i: f for i, f in enumerate(sorted(self.images.glob("*")))
                if f.is_dir()
            }
            if not folders:
                raise FileNotFoundError(f"no images under {self.images}")
        for idx, folder in folders.items():
            out = root / str(idx) if not has_images else root
            proj = {
                "images": folder,
                "output": out,
                "sparse": out / "sparse",
                "mvs": out / "dense",
                "database": out / "database.db",
                "option": out / "options",
            }
            proj["option"].mkdir(parents=True, exist_ok=True)
            proj["sparse"].mkdir(parents=True, exist_ok=True)
            self.projects[idx] = proj

    # -- stage cache (option stamps, recunstruction.py:155-211) ----------------

    def _stamp_path(self, proj: dict, stage: str) -> Path:
        return proj["option"] / f"{stage}_options.json"

    def _is_done(self, proj: dict, stage: str, options: dict) -> bool:
        path = self._stamp_path(proj, stage)
        if not path.exists():
            return False
        try:
            return json.loads(path.read_text()) == options
        except json.JSONDecodeError:
            return False

    def _mark_done(self, proj: dict, stage: str, options: dict) -> None:
        self._stamp_path(proj, stage).write_text(json.dumps(options))

    def _require_backend(self):
        if self.backend is None:
            raise PycolmapNotFoundError(
                "pycolmap is not installed; use "
                "reconstruction.colmap_driver.COLMAPReconstruction "
                "(subprocess) or install pycolmap"
            )
        return self.backend

    @staticmethod
    def _options_dict(opts) -> dict:
        """JSON-able stamp of a pycolmap options object."""
        if opts is None:
            return {}
        if hasattr(opts, "todict"):
            d = opts.todict()
        elif hasattr(opts, "__dict__"):
            d = dict(opts.__dict__)
        else:
            return {"repr": repr(opts)}
        out = {}
        for k, v in d.items():
            try:
                json.dumps(v)
                out[k] = v
            except (TypeError, OverflowError):
                out[k] = str(v)
        return out

    # -- stages -----------------------------------------------------------------

    def extract_features(self) -> None:
        pc = self._require_backend()
        sift = pc.SiftExtractionOptions()
        stamp = {"sift": self._options_dict(sift), "camera": self.camera.model}
        for proj in self.projects.values():
            if self._is_done(proj, "feature_extraction", stamp):
                continue
            pc.extract_features(
                proj["database"],
                proj["images"],
                camera_mode=pc.CameraMode("SINGLE"),
                sift_options=sift,
            )
            self._mark_done(proj, "feature_extraction", stamp)

    def match_features(self) -> None:
        pc = self._require_backend()
        sift = pc.SiftMatchingOptions()
        if self.matching == "exhaustive":
            matcher, mopts = pc.match_exhaustive, pc.ExhaustiveMatchingOptions()
        else:
            matcher, mopts = pc.match_spatial, pc.SpatialMatchingOptions()
            mopts.ignore_z = False
        stamp = {
            "mode": self.matching,
            "sift": self._options_dict(sift),
            "matching": self._options_dict(mopts),
        }
        for proj in self.projects.values():
            if self._is_done(proj, "feature_matching", stamp):
                continue
            matcher(
                database_path=proj["database"],
                sift_options=sift,
                matching_options=mopts,
            )
            self._mark_done(proj, "feature_matching", stamp)

    def incremental_mapping(self) -> None:
        pc = self._require_backend()
        mopts = pc.IncrementalMapperOptions()
        stamp = self._options_dict(mopts)
        for proj in self.projects.values():
            if self._is_done(proj, "incremental_sfm", stamp):
                continue
            maps = pc.incremental_mapping(
                database_path=proj["database"],
                image_path=proj["images"],
                output_path=proj["sparse"],
                options=mopts,
            )
            if not maps:
                raise RuntimeError(
                    f"incremental mapping produced no model for {proj['images']}"
                )
            first = maps[0] if isinstance(maps, (list, tuple)) else maps[
                sorted(maps)[0]
            ]
            first.write(proj["sparse"])
            self._mark_done(proj, "incremental_sfm", stamp)

    def undistort_images(self) -> None:
        pc = self._require_backend()
        for proj in self.projects.values():
            if (proj["mvs"] / "images").exists():
                continue
            pc.undistort_images(proj["mvs"], proj["sparse"], proj["images"])

    def patch_match_stereo(self) -> None:
        pc = self._require_backend()
        opts = pc.PatchMatchOptions()
        opts.window_radius = 8
        opts.num_iterations = 7
        opts.max_image_size = self.patch_match_max_image_size
        stamp = self._options_dict(opts)
        for proj in self.projects.values():
            if self._is_done(proj, "patch_match_stereo", stamp):
                continue
            pc.patch_match_stereo(proj["mvs"], options=opts)
            self._mark_done(proj, "patch_match_stereo", stamp)

    def stereo_fusion(self) -> None:
        pc = self._require_backend()
        opts = pc.StereoFusionOptions()
        opts.max_image_size = self.stereo_fusion_max_image_size
        if hasattr(opts, "num_threads"):
            opts.num_threads = min(16, os.cpu_count() or 1)
        stamp = self._options_dict(opts)
        for proj in self.projects.values():
            if self._is_done(proj, "stereo_fusion", stamp):
                continue
            pc.stereo_fusion(
                output_path=proj["mvs"] / "fused.ply",
                workspace_path=proj["mvs"],
                workspace_format="COLMAP",
                input_type="geometric",
                options=opts,
            )
            self._mark_done(proj, "stereo_fusion", stamp)

    def run(self) -> dict:
        """Full pipeline (reference: recunstruction.py:343-353); returns
        the project table for downstream loaders."""
        self.extract_features()
        self.match_features()
        self.incremental_mapping()
        if self.dense:
            self.undistort_images()
            self.patch_match_stereo()
            self.stereo_fusion()
        return self.projects
