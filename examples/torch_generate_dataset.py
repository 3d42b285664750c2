"""Worked example: the scene loop of ``examples/generate_dataset.py`` on the
PyTorch/CUDA port (``pegasus_tpu_torch``).

Wires environments and objects, runs N scenes of physics and rendering on
the card, and writes a BOP dataset (plus gt-info and NDDS).  Point
RAMEN_PATH / PEGASET_PATH at the released archives, or pass no dataset and
the example builds a small synthetic one (asphalt and three cups).

Usage:
  python examples/torch_generate_dataset.py [out_dir] [num_scenes]
"""

import os
import sys
from pathlib import Path

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.generate import run_generation

OBJECTS = (("cup_noodles_04", 104), ("cup_noodles_07", 107), ("cup_noodles_01", 101))


def main(out_dir="./dataset", num_scenes: int = 2, dataset_path=None, width: int = 640,
         height: int = 480, num_cameras: int = 4, interpolation_steps: int = 10,
         simulation_steps: int = 310, device="cuda"):
    """Generate ``num_scenes`` static scenes; returns the run's SceneStats."""
    if dataset_path is None:
        from pegasus_tpu_torch.testing import build_synthetic_dataset

        dataset_path = Path(out_dir) / "synthetic_assets"
        build_synthetic_dataset(dataset_path, object_names=[n for n, _ in OBJECTS])
    env = Asset(OBJECT_NAME="asphalt", ID=1003, TYPE="environment",
                dataset_path=str(dataset_path))
    objs = [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(dataset_path)) for n, i in OBJECTS]
    config = GenerationConfig(
        dataset_path=str(dataset_path), env_dataset_path=str(dataset_path),
        urdf_asset_folder=str(Path(dataset_path) / "urdf"), dataset_base_path=str(out_dir),
        dataset_name="pegasus_torch_example", num_scenes=num_scenes, min_num_objects=1,
        max_num_objects=len(objs), render_width=width, render_height=height,
        num_cameras=num_cameras, num_camera_interpolation_steps=interpolation_steps,
        simulation_steps=simulation_steps, mode="static", save_video=False, seed=0,
    )
    return run_generation(config, [env], objs, device=device)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "./dataset"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    stats = main(out, n, dataset_path=os.environ.get("PEGASET_PATH"))
    print(f"wrote {len(stats.records)} scenes under {out}/pegasus_torch_example")
