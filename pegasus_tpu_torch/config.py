"""Copied verbatim from ``pegasus_tpu/config.py``; only the comments on ``splat_budget`` and ``compact_readback`` and the default dataset name differ.

Declarative generation config.

Replaces the reference's three config layers (SURVEY 5: argparse groups
combined with saved cfg_args via a sys.argv hack at pegasus.py:151-154,
class constants, and hardcoded __main__ literals) with one dataclass that
serializes to JSON next to the generated dataset.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class GenerationConfig:
    # scene composition
    dataset_path: str = "."
    env_dataset_path: Optional[str] = None
    urdf_asset_folder: Optional[object] = None  # str | list[str]
    dataset_base_path: str = "./dataset"
    dataset_name: str = "pegasus_tpu_torch"
    num_scenes: int = 10
    min_num_objects: int = 3
    max_num_objects: int = 6
    mode: str = "static"  # 'static' | 'dynamic'
    # rendering
    render_width: int = 640
    render_height: int = 480
    num_cameras: int = 10
    num_camera_interpolation_steps: int = 30
    camera_trajectory_mode: str = "random"
    render_data_points: List[str] = field(
        default_factory=lambda: ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]
    )
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sh_degree: int = 3
    load_iteration: int = 30_000
    # physics
    simulation_steps: int = 310
    gravity: Tuple[float, float, float] = (0.0, 0.0, -50.0)
    physics_dt: float = 1e-3
    # output
    convert_scenewise_to_imagewise: bool = True
    save_video: bool = True
    unit_scale: float = 1000.0  # BOP millimeters
    # execution
    seed: Optional[int] = None
    splat_budget: Optional[int] = None  # sequential path: pad every scene to this
    # many splats; the sharded path reads it nowhere (no static shapes to keep)
    resume: bool = True  # skip scenes with finalized annotations
    frame_chunk: int = 8  # frames per device dispatch/readback
    compact_readback: bool = False  # device-side RLE of each chunk's sparse planes

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path) -> "GenerationConfig":
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})
