"""Worked example: create a PEGASUS asset with the PyTorch/CUDA port,
photos to URDF.

The port's counterpart of ``examples/reconstruct_asset.py``: COLMAP SfM ->
metric scale -> plane alignment -> 3DGS training on the card (the
compositor kernels) -> alpha-shape URDF generation -> GS cleaning.

Structure from motion needs an external COLMAP executable on PATH (or
COLMAP_EXE).  Without photos of your own, ``demo`` lays out a synthetic
hemispherical scan of a box (views rendered from a known cloud) and puts
``testing.COLMAP_STUB`` on PATH in place of COLMAP: the stub answers the
feature extraction and matching by touching the database and the mapper
by installing the scan's pre-baked sparse model, so SfM itself does not
run; every other stage does.

Usage:
  python examples/torch_reconstruct_asset.py env  <dataset_root> <AssetClassName>
  python examples/torch_reconstruct_asset.py obj  <dataset_root> <AssetClassName>
  python examples/torch_reconstruct_asset.py wild <dataset_root> <AssetClassName>
  python examples/torch_reconstruct_asset.py demo <work_dir> [iterations]
"""

import os
import shutil
import sys
from pathlib import Path

import numpy as np

from pegasus_tpu_torch.reconstruction.recipes import (environment_reconstruction,
                                                      hemispherical_object_reconstruction,
                                                      in_the_wild_object_reconstruction,
                                                      spherical_object_reconstruction)

RECIPES = {
    "env": environment_reconstruction,
    "obj": spherical_object_reconstruction,
    "wild": in_the_wild_object_reconstruction,
}


def main(work_dir, iterations: int = 600, size: int = 256, n_images: int = 16,
         n_seeds: int = 8000, device="cuda"):
    """The demo: a synthetic scan of a box through the hemispherical
    recipe with the COLMAP stub.  Returns the Asset (its paths hold the
    trained ply, the mesh and the URDF)."""
    from pegasus_tpu_torch.assets.registry import Asset
    from pegasus_tpu_torch.testing import install_colmap_stub, make_box_cloud, write_colmap_scan

    work = Path(work_dir)
    scan = work / "scan"
    box = make_box_cloud(np.random.default_rng(7), n=4 * n_seeds, half_extents=(0.15, 0.15, 0.18),
                         rgb=(0.6, 0.4, 0.3), object_id=0, device=device)
    write_colmap_scan(scan, box, size, n_images=n_images, n_seeds=n_seeds)
    up = work / "data" / "object" / "scanned_box" / "up"
    up.mkdir(parents=True)
    shutil.move(str(scan / "images"), str(up / "images"))
    install_colmap_stub(work / "bin")
    saved = {k: os.environ.get(k) for k in ("PATH", "COLMAP_STUB_MODEL")}
    os.environ["PATH"] = f"{work / 'bin'}{os.pathsep}{os.environ['PATH']}"
    os.environ["COLMAP_STUB_MODEL"] = str(scan / "sparse" / "0")
    try:
        asset = Asset(OBJECT_NAME="scanned_box", ID=901, dataset_path=str(work / "data"),
                      SCALE=False, ALPHA=0.05)
        hemispherical_object_reconstruction(asset, train_iterations=iterations, device=device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return asset


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "demo":
        asset = main(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 600)
    elif len(sys.argv) == 4 and sys.argv[1] in RECIPES:
        from pegasus_tpu_torch.assets.rosters import full_registry

        kind, root, class_name = sys.argv[1:4]
        asset = full_registry(root).by_class_name(class_name)
        RECIPES[kind](asset)
    else:
        print(__doc__)
        sys.exit(2)
    print(f"[torch_reconstruct_asset] {asset.OBJECT_NAME}: GS model at "
          f"{asset.gs_model_path}, URDF at {asset.urdf_file_path}")
