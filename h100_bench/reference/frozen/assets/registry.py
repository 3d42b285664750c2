"""Frozen copy of pegasus_tpu_torch/assets/registry.py at commit 7a69f88, cut to what the benchmark calls.

Copied verbatim from ``pegasus_tpu/assets/registry.py``; only the import lines differ.

Declarative asset registry.

The reference defines every asset as a Python class with constants and
path helpers (`CupNoodle01`, `Asphalt`, ... — contract recovered in
SURVEY 2.3.2 from README.md:159-187 and call sites).  Here the single
``Asset`` dataclass carries the same metadata, instances are built either
from a JSON manifest or from the generated compat rosters
(pegasus_tpu.assets.ycb_objects / cup_noodle_dataset / dataset_envs), and
the directory layout of the released Ramen/PEGASET datasets
(README.md:218-253) is encoded once in the path helpers.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Literal

import numpy as np


@dataclass
class Asset:
    """One reconstructable entity (object or environment).

    Field names mirror the reference's class constants (README.md:163-187):
    OBJECT_NAME, ID, TYPE, RECORDING_TYPE, ALPHA, DATASET_TYPE, ARUCO_SIZE;
    the path helpers mirror the members observed at call sites
    (SURVEY 2.3.2).
    """

    OBJECT_NAME: str
    ID: int
    TYPE: Literal["object", "environment"] = "object"
    RECORDING_TYPE: Literal["spherical", "hemispherical", "wild"] = "spherical"
    ALPHA: float = 0.05  # alpha-shape parameter for URDF meshing
    DATASET_TYPE: str = "ycb"
    ARUCO_SIZE: float = 0.15  # meters
    SCALE: object = True  # True=aruco, float=constant scale
    PLANE_NORMAL: tuple = (0.0, 0.0, 1.0)  # align2plane target normal
    MATCHING: dict | None = None  # mapper settings for down-image registration
    CALIBRATION_OBJECT: object = None  # calibration-board asset/class ref
    REFERENCE_DATASET_PATH: str | None = None
    camera_model: str = "OPENCV"
    resize: object = False  # False | True (0.5) | float factor
    dataset_path: str = "."
    START_POSITION_PYBULLET: tuple = (0.0, 0.0, 0.0)
    # environments: drop-region half-extents for define_start_pos
    DROP_REGION: tuple = (0.15, 0.15)
    DROP_HEIGHT: tuple = (0.25, 0.45)
    mode: Literal["up", "down", "fused"] = "fused"

    # -- identity --------------------------------------------------------------

    @property
    def object_name(self) -> str:
        return self.OBJECT_NAME

    @property
    def class_name(self) -> str:
        return type(self).__name__ if type(self) is not Asset else self.OBJECT_NAME

    # -- dataset layout (README.md:218-253) -------------------------------------

    @property
    def base_path(self) -> Path:
        # released dataset layout: <dataset>/{object,environment}/<name>
        # (README.md:218-253)
        sub = "environment" if self.TYPE == "environment" else "object"
        return Path(self.dataset_path) / sub / self.OBJECT_NAME

    @property
    def _mode_dir(self) -> Path:
        if self.TYPE == "environment":
            return self.base_path
        return self.base_path / self.mode

    @property
    def reconstruction_path(self) -> str:
        return str(self._mode_dir)

    @property
    def gs_model_path(self) -> str:
        return str(self._mode_dir / "gs")

    def gaussian_point_cloud_path(self, iteration: int = 30_000) -> str:
        return str(
            Path(self.gs_model_path)
            / "point_cloud"
            / f"iteration_{iteration}"
            / "point_cloud.ply"
        )


    @property
    def urdf_file_name(self) -> str:
        return f"{self.OBJECT_NAME}.urdf"


    @property
    def urdf_obj_path(self) -> str:
        return str(Path(self.dataset_path) / "urdf" / f"{self.OBJECT_NAME}.obj")

    # -- behavior ---------------------------------------------------------------

    def define_start_pos(self, rng: np.random.Generator | None = None) -> list:
        """Random drop position above the environment
        (contract: pegasus.py:215; environments only)."""
        rng = rng or np.random.default_rng()
        rx, ry = self.DROP_REGION
        lo, hi = self.DROP_HEIGHT
        return [
            float(rng.uniform(-rx, rx)),
            float(rng.uniform(-ry, ry)),
            float(rng.uniform(lo, hi)),
        ]


    # -- manifest ---------------------------------------------------------------


