"""Copied verbatim from ``pegasus_tpu/assets/registry.py``; only the import lines differ.

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

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Literal, Optional

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

    def gs_o3d_point_cloud_path(self, iteration: int = 30_000) -> str:
        return str(
            Path(self.gs_model_path)
            / "point_cloud"
            / f"iteration_{iteration}"
            / "point_cloud_o3d.ply"
        )

    @property
    def urdf_file_name(self) -> str:
        return f"{self.OBJECT_NAME}.urdf"

    @property
    def urdf_file_path(self) -> str:
        return str(Path(self.dataset_path) / "urdf" / self.urdf_file_name)

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

    def environment_object(self) -> bool:
        return self.TYPE == "environment"

    # -- manifest ---------------------------------------------------------------

    def to_manifest(self) -> dict:
        return {
            "object_name": self.OBJECT_NAME,
            "id": self.ID,
            "type": self.TYPE,
            "recording_type": self.RECORDING_TYPE,
            "alpha": self.ALPHA,
            "dataset_type": self.DATASET_TYPE,
            "aruco_size": self.ARUCO_SIZE,
        }

    @classmethod
    def from_manifest(cls, entry: dict, dataset_path: str = ".") -> "Asset":
        return cls(
            OBJECT_NAME=entry["object_name"],
            ID=int(entry["id"]),
            TYPE=entry.get("type", "object"),
            RECORDING_TYPE=entry.get("recording_type", "spherical"),
            ALPHA=float(entry.get("alpha", 0.05)),
            DATASET_TYPE=entry.get("dataset_type", "ycb"),
            ARUCO_SIZE=float(entry.get("aruco_size", 0.15)),
            dataset_path=dataset_path,
        )


class AssetRegistry:
    """Name- and id-addressable asset collection with manifest round trip."""

    def __init__(self, assets: Optional[List[Asset]] = None):
        self._by_name: Dict[str, Asset] = {}
        self._by_id: Dict[int, Asset] = {}
        for a in assets or []:
            self.add(a)

    def add(self, asset: Asset) -> Asset:
        self._by_name[asset.OBJECT_NAME] = asset
        self._by_id[asset.ID] = asset
        return asset

    def by_name(self, name: str) -> Asset:
        return self._by_name[name]

    def by_id(self, asset_id: int) -> Asset:
        return self._by_id[asset_id]

    def by_class_name(self, class_name: str) -> Asset:
        """getattr(env_assets, class_name) equivalent
        (reference: src/gs/pegasus_setup.py:62)."""
        for a in self._by_name.values():
            if a.class_name == class_name or a.OBJECT_NAME == class_name:
                return a
        raise KeyError(class_name)

    def objects(self) -> List[Asset]:
        return [a for a in self._by_name.values() if a.TYPE == "object"]

    def environments(self) -> List[Asset]:
        return [a for a in self._by_name.values() if a.TYPE == "environment"]

    def __len__(self):
        return len(self._by_name)

    def __iter__(self):
        return iter(self._by_name.values())

    def save_manifest(self, path) -> None:
        with open(path, "w") as f:
            json.dump([a.to_manifest() for a in self], f, indent=1)

    @classmethod
    def load_manifest(cls, path, dataset_path: str = ".") -> "AssetRegistry":
        with open(path) as f:
            entries = json.load(f)
        return cls([Asset.from_manifest(e, dataset_path) for e in entries])
