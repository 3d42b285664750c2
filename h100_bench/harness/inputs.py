"""Inputs made from fixed seeds by frozen generators, cached inside the
checkout under a digest of the configuration and the generators' sources.

Both sides of a comparison read the same inputs: the program through its
loaders, the plain reference through its frozen copies of them.

* ``asset_library``: a PEGASET-layout dataset (one environment, the
  roster's objects) written by ``reference.frozen.testing``'s generators.
* ``training_scan``: the hemisphere scan an asset is trained from: views
  rendered from a box cloud by the frozen plain renderer, seed points drawn
  from its splats.  Kept as one ``.npz``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np

from harness.core import BENCH, CACHE

FROZEN = BENCH / "reference" / "frozen"
GENERATORS = (Path(__file__), FROZEN / "testing.py", FROZEN / "gs" / "ply.py", FROZEN / "gs" / "cloud.py",
              FROZEN / "io" / "colmap.py", FROZEN / "io" / "mesh.py", FROZEN / "physics" / "urdf.py")
RENDERERS = (FROZEN / "ops" / "projection.py", FROZEN / "ops" / "binning.py",
             FROZEN / "ops" / "rasterize_cuda.py", FROZEN / "camera.py", FROZEN / "utils" / "sh.py")


def digest(data: dict, sources) -> str:
    h = hashlib.sha256(json.dumps(data, sort_keys=True).encode())
    for p in sources:
        h.update(Path(p).read_bytes())
    return h.hexdigest()[:16]


def _cached(kind: str, key: str, build, cache: Path) -> Path:
    """``cache/<kind>-<key>``, built once by ``build(tmp_dir)`` and moved
    into place whole, so that a cut-off build is never taken."""
    final = cache / f"{kind}-{key}"
    if final.is_dir():
        return final
    tmp = cache / f".{kind}-{key}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    build(tmp)
    os.replace(tmp, final)
    return final


def roster_classes(config: dict):
    from reference.frozen.assets.rosters import ENV_CLASSES, YCB_CLASSES

    envs = [ENV_CLASSES[n] for n in config["environments"]]
    objs = [YCB_CLASSES[n] for n in config["objects"]]
    return envs, objs


def asset_library(config: dict, cache: Path = CACHE, say=print) -> Path:
    """The dataset root of ``config``'s environments and objects."""
    spec = {k: config[k] for k in ("environments", "objects", "assets")}

    def build(root: Path) -> None:
        from reference.frozen.testing import build_synthetic_dataset

        t0 = time.perf_counter()
        a = config["assets"]
        envs, objs = roster_classes(config)
        rng = np.random.default_rng(a["seed"])
        names = [cls(root).object_name for cls in objs]
        for i, env in enumerate(envs):
            build_synthetic_dataset(root, env_name=env(root).object_name,
                                    object_names=names if i == 0 else (),
                                    n_colmap_images=a["colmap_images"], rng=rng,
                                    env_splats=a["env_splats"], obj_splats=a["obj_splats"])
        say(f"asset library written in {time.perf_counter() - t0:.3f} s")

    return _cached("assets", digest(spec, GENERATORS), build, cache)


def training_scan(config: dict, device, cache: Path = CACHE, say=print) -> Path:
    """``scan.npz``: uint8 views [V, S, S, 3], COLMAP qvecs / tvecs, the
    field of view, seed points and their uint8 colours."""
    spec = config["scan"]

    def build(root: Path) -> None:
        import torch

        from reference.frozen.camera import Camera
        from reference.frozen.ops.rasterize_cuda import rasterize
        from reference.frozen.testing import make_box_cloud, make_colmap_hemisphere
        from reference.frozen.utils import sh as shlib
        from reference.frozen.utils.pose import focal2fov

        t0 = time.perf_counter()
        size = spec["size"]
        gt = make_box_cloud(np.random.default_rng(spec["cloud_seed"]), n=spec["cloud_splats"],
                            half_extents=tuple(spec["half_extents"]), rgb=tuple(spec["rgb"]),
                            object_id=0, device=device)
        focal = size / (2 * np.tan(np.radians(spec["fov_deg"]) / 2))
        _, images = make_colmap_hemisphere(n_images=spec["views"], radius=spec["radius"],
                                           width=size, height=size, focal=focal)
        fov = focal2fov(focal, size)
        views = []
        with torch.no_grad():
            for im in images.values():
                cam = Camera.from_colmap(im.qvec, im.tvec, fov, fov, size, size, device=device)
                rgb = torch.clamp(rasterize(gt, cam, max_objects=1).rgb, 0, 1)
                views.append((rgb * 255).to(torch.uint8).cpu().numpy())
        rng = np.random.default_rng(spec["seed_points_seed"])
        idx = rng.choice(gt.num_splats, spec["seed_points"], replace=False)
        xyz = gt.xyz[idx].cpu().numpy() + rng.normal(size=(spec["seed_points"], 3)) * 0.005
        rgb = (np.clip(shlib.sh2rgb(gt.f_dc[idx, 0].cpu().numpy()), 0, 1) * 255).astype(np.uint8)
        np.savez(root / "scan.npz", views=np.stack(views), fov=np.float64(fov),
                 qvec=np.stack([im.qvec for im in images.values()]),
                 tvec=np.stack([im.tvec for im in images.values()]),
                 points=xyz.astype(np.float64), colors=rgb)
        say(f"training scan rendered in {time.perf_counter() - t0:.3f} s")

    return _cached("scan", digest(spec, GENERATORS + RENDERERS), build, cache) / "scan.npz"


def load_scan(path: Path) -> dict:
    """The scan's arrays, with the images as float32 in [0, 1] (as the
    training wrapper reads its PNGs) and the scene extent of the cameras'
    centres (``scene/dataset.py``'s rule)."""
    from reference.frozen.utils.pose import qvec2rotmat

    with np.load(path) as z:
        scan = {k: z[k] for k in z.files}
    centers = np.stack([-qvec2rotmat(q).T @ t for q, t in zip(scan["qvec"], scan["tvec"])])
    extent = float(np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1
    scan["extent"] = max(extent, 1e-3)
    scan["images"] = scan["views"].astype(np.float32) / 255.0
    scan["point_colors"] = scan["colors"].astype(np.float32) / 255.0
    return scan
