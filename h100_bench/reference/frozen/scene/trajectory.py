"""Frozen copy of pegasus_tpu_torch/scene/trajectory.py at commit 7a69f88, cut to what the benchmark calls.

Copied verbatim from ``pegasus_tpu/scene/trajectory.py``; only the import lines differ.

Physics trajectory container, schema-compatible with the reference.

The physics -> rendering handoff in PEGASUS is a JSON file
(reference: src/engine/physical_simulation.py:163-168):

    {"asset_infos": {"environment": {name: {"bullet_id": [id],
                                            "class_name": str}},
                     "object": {name: {"bullet_id": [ids...],
                                       "center_of_mass": [3],
                                       "class_name": str,
                                       "object_ID": int}}},
     "trajectory": {body_id: {step: {"t": [3], "q": [4 xyzw]}}}}

We keep that file format as the resume/interchange point (consumable by
either engine) and additionally hold the trajectory as dense arrays for
vmapped device-side replay.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class AssetInfo:
    name: str
    class_name: str
    bullet_ids: List[int]
    object_ID: int | None = None  # real dataset id (objects only)
    center_of_mass: List[float] | None = None


@dataclass
class Trajectory:
    environment: AssetInfo
    objects: Dict[str, AssetInfo]  # keyed by asset name
    times_t: np.ndarray  # [B, T, 3] positions per body id (body 0 = env)
    times_q: np.ndarray  # [B, T, 4] xyzw quaternions per body id

    @property
    def num_bodies(self) -> int:
        return self.times_t.shape[0]

    @property
    def num_steps(self) -> int:
        return self.times_t.shape[1]

    def object_bullet_ids(self) -> List[int]:
        ids = []
        for info in self.objects.values():
            ids.extend(info.bullet_ids)
        return sorted(ids)

    def bullet_id_to_asset(self) -> Dict[int, AssetInfo]:
        out = {}
        for info in self.objects.values():
            for bid in info.bullet_ids:
                out[bid] = info
        return out


    # -- JSON interchange ----------------------------------------------------


    def to_dict(self) -> dict:
        asset_infos = {
            "environment": {
                self.environment.name: {
                    "bullet_id": self.environment.bullet_ids,
                    "class_name": self.environment.class_name,
                }
            },
            "object": {},
        }
        for name, info in self.objects.items():
            entry = {
                "bullet_id": info.bullet_ids,
                "class_name": info.class_name,
            }
            if info.center_of_mass is not None:
                entry["center_of_mass"] = list(info.center_of_mass)
            if info.object_ID is not None:
                entry["object_ID"] = info.object_ID
            asset_infos["object"][name] = entry
        trajectory = {}
        for b in range(self.num_bodies):
            trajectory[str(b)] = {
                str(s): {
                    "t": [float(v) for v in self.times_t[b, s]],
                    "q": [float(v) for v in self.times_q[b, s]],
                }
                for s in range(self.num_steps)
            }
        return {"asset_infos": asset_infos, "trajectory": trajectory}

    def to_json(self, path) -> None:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
