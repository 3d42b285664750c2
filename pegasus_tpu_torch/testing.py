"""Synthetic fixtures: procedurally generated Gaussian clouds, meshes and
COLMAP models, with the exact on-disk schemas of the real assets (Inria PLY,
COLMAP bin, OBJ, URDF).

Port of ``pegasus_tpu/testing.py``: the same numpy draws in the same order,
so a generator given the same ``numpy.random.Generator`` state yields the
same splats as the reference's (SH DC terms are computed in float32, as the
reference computes them).  Clouds are built on ``device``, the card by default.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pegasus_tpu_torch.device import DEFAULT_DEVICE
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.utils import sh as shlib

# Assets of the recorded smoke trajectory (tests/data/torch_smoke_trajectory.json):
# the environment and six objects with their asset ids.
SMOKE_ENV = ("asphalt", 1003)
SMOKE_OBJECTS = tuple((f"cup_noodles_{i:02d}", 100 + i) for i in range(1, 7))


def _rgb2sh32(rgb) -> np.ndarray:
    return shlib.rgb2sh(np.asarray(rgb, np.float32))


def make_random_cloud(
    rng: np.random.Generator,
    n: int = 256,
    center=(0.0, 0.0, 0.0),
    extent: float = 0.5,
    scale_range=(-5.5, -4.0),
    opacity_logit: float = 6.0,
    sh_degree: int = 3,
    rest_std: float = 0.05,
    object_id: int = 0,
    device=DEFAULT_DEVICE,
) -> GaussianCloud:
    """A blob of random splats around `center` (generic test object)."""
    xyz = rng.normal(size=(n, 3)) * extent / 3.0 + np.asarray(center)
    f_dc = _rgb2sh32(rng.uniform(0.1, 0.9, size=(n, 1, 3)))
    k = (sh_degree + 1) ** 2 - 1
    f_rest = rng.normal(size=(n, k, 3)) * rest_std
    opacity = np.full((n, 1), opacity_logit)
    scale = rng.uniform(*scale_range, size=(n, 3))
    rot = rng.normal(size=(n, 4))
    return GaussianCloud.create(
        xyz=xyz, f_dc=f_dc, f_rest=f_rest, opacity=opacity, scale=scale, rot=rot,
        object_id=np.full((n,), object_id, np.int32), device=device,
    )


def make_plane_cloud(
    rng: np.random.Generator,
    n: int = 1024,
    size: float = 2.0,
    z: float = 0.0,
    rgb=(0.4, 0.35, 0.3),
    sh_degree: int = 3,
    device=DEFAULT_DEVICE,
) -> GaussianCloud:
    """A flat ground-plane cloud (synthetic 'environment', object_id 0)."""
    xy = rng.uniform(-size / 2, size / 2, size=(n, 2))
    xyz = np.concatenate([xy, np.full((n, 1), z)], axis=1)
    base = np.asarray(rgb) + rng.normal(size=(n, 3)) * 0.03
    f_dc = _rgb2sh32(np.clip(base, 0, 1))[:, None, :]
    k = (sh_degree + 1) ** 2 - 1
    f_rest = np.zeros((n, k, 3))
    opacity = np.full((n, 1), 8.0)
    # flat disks: small z-scale
    scale = np.stack(
        [
            np.full(n, np.log(size / np.sqrt(n) * 1.2)),
            np.full(n, np.log(size / np.sqrt(n) * 1.2)),
            np.full(n, np.log(1e-3)),
        ],
        axis=1,
    )
    rot = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    return GaussianCloud.create(
        xyz=xyz, f_dc=f_dc, f_rest=f_rest, opacity=opacity, scale=scale, rot=rot,
        device=device,
    )


def make_box_cloud(
    rng: np.random.Generator,
    n: int = 512,
    half_extents=(0.05, 0.05, 0.08),
    center=(0.0, 0.0, 0.0),
    rgb=(0.8, 0.2, 0.2),
    object_id: int = 1,
    sh_degree: int = 3,
    device=DEFAULT_DEVICE,
) -> GaussianCloud:
    """Splats on the surface of a box (synthetic 'object')."""
    he = np.asarray(half_extents)
    # sample points on box faces proportional to face area
    areas = np.array(
        [he[1] * he[2], he[1] * he[2], he[0] * he[2], he[0] * he[2], he[0] * he[1], he[0] * he[1]]
    )
    face = rng.choice(6, size=n, p=areas / areas.sum())
    uv = rng.uniform(-1, 1, size=(n, 2))
    pts = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        others = [a for a in range(3) if a != axis]
        pts[m, axis] = sign * he[axis]
        pts[m, others[0]] = uv[m, 0] * he[others[0]]
        pts[m, others[1]] = uv[m, 1] * he[others[1]]
    xyz = pts + np.asarray(center)
    base = np.asarray(rgb) + rng.normal(size=(n, 3)) * 0.05
    f_dc = _rgb2sh32(np.clip(base, 0, 1))[:, None, :]
    k = (sh_degree + 1) ** 2 - 1
    f_rest = rng.normal(size=(n, k, 3)) * 0.02
    opacity = np.full((n, 1), 7.0)
    s = float(np.mean(he)) / np.sqrt(n) * 6.0
    scale = np.full((n, 3), np.log(s))
    rot = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    return GaussianCloud.create(
        xyz=xyz, f_dc=f_dc, f_rest=f_rest, opacity=opacity, scale=scale, rot=rot,
        object_id=np.full((n,), object_id, np.int32), device=device,
    )


def make_box_mesh(half_extents=(0.05, 0.05, 0.08), center=(0.0, 0.0, 0.0)):
    """(vertices [8,3], faces [12,3]) axis-aligned box mesh."""
    he = np.asarray(half_extents, np.float64)
    c = np.asarray(center, np.float64)
    signs = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    )
    verts = signs * he + c
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom
            [4, 5, 6], [4, 6, 7],  # top
            [0, 1, 5], [0, 5, 4],
            [1, 2, 6], [1, 6, 5],
            [2, 3, 7], [2, 7, 6],
            [3, 0, 4], [3, 4, 7],
        ],
        np.int32,
    )
    return verts, faces


def make_tile_pileup(
    rng: np.random.Generator,
    tile_counts: dict,
    width: int,
    height: int,
    max_objects: int = 1,
    device=DEFAULT_DEVICE,
):
    """Projected splats piled onto chosen tiles: ``tile_counts[t]`` splats
    whose 3-sigma boxes lie inside 16x16 tile t (row-major), so that exact
    binning gives tile t exactly that many entries and every other tile
    none.  Radii 1.5-6 px, random conics, opacities 0.01-0.6, distinct
    random depths, object ids in [0, max_objects).  Returns a
    ``ProjectedGaussians`` for ``bin_splats``."""
    import torch

    from pegasus_tpu_torch.ops.projection import ProjectedGaussians

    ntx = -(-width // 16)
    tiles = np.concatenate([np.full(n, t, np.int64) for t, n in tile_counts.items()])
    n = tiles.size
    r = rng.uniform(1.5, 6.0, n)
    lo_x, lo_y = (tiles % ntx) * 16.0, (tiles // ntx) * 16.0
    mx = lo_x + r + 0.01 + rng.uniform(0, 1, n) * (16.0 - 2 * r - 0.02)
    my = lo_y + r + 0.01 + rng.uniform(0, 1, n) * (16.0 - 2 * r - 0.02)
    sx, sy = r / 3 * rng.uniform(0.5, 1.0, n), r / 3 * rng.uniform(0.5, 1.0, n)
    rho = rng.uniform(-0.6, 0.6, n)
    det = (sx * sy) ** 2 * (1 - rho**2)
    cols = {
        "mean_x": mx, "mean_y": my,
        "conic_a": sy**2 / det, "conic_b": -rho * sx * sy / det, "conic_c": sx**2 / det,
        "color_r": rng.uniform(0, 1, n), "color_g": rng.uniform(0, 1, n),
        "color_b": rng.uniform(0, 1, n),
        "opacity": rng.uniform(0.01, 0.6, n), "depth": rng.permutation(n) * 1e-3 + 1.0,
        "radius": r,
    }
    t = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in cols.items()}
    return ProjectedGaussians(
        **t,
        object_id=torch.tensor(rng.integers(0, max_objects, n), dtype=torch.int32, device=device),
        valid=torch.ones(n, dtype=torch.bool, device=device),
    )


def make_colmap_hemisphere(
    n_images: int = 24,
    radius: float = 1.5,
    target=(0.0, 0.0, 0.0),
    width: int = 640,
    height: int = 480,
    focal: float = 600.0,
):
    """Synthetic COLMAP model: cameras on a hemisphere looking at `target`.
    Returns (cameras dict, images dict) in ``io.colmap`` types."""
    from pegasus_tpu_torch.io.colmap import ColmapCamera, ColmapImage
    from pegasus_tpu_torch.utils.pose import rotmat2qvec

    cams = {
        1: ColmapCamera(
            1, "PINHOLE", width, height, np.array([focal, focal, width / 2, height / 2])
        )
    }
    images = {}
    tgt = np.asarray(target, np.float64)
    for i in range(n_images):
        az = 2 * np.pi * i / n_images
        el = np.deg2rad(35.0 + 20.0 * np.sin(3 * az))
        eye = tgt + radius * np.array(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)]
        )
        fwd = tgt - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R_w2c = np.stack([right, down, fwd], axis=0)
        t_w2c = -R_w2c @ eye
        images[i + 1] = ColmapImage(
            id=i + 1,
            qvec=rotmat2qvec(R_w2c),
            tvec=t_w2c,
            camera_id=1,
            name=f"frame_{i:04d}.png",
        )
    return cams, images


def build_synthetic_dataset(
    root,
    env_name: str = "asphalt",
    object_names=("cup_noodles_04", "cup_noodles_07"),
    n_colmap_images: int = 16,
    rng=None,
    env_splats: int = 2048,
    obj_splats: int = 768,
):
    """Materialize a minimal Ramen/PEGASET-layout dataset on disk:

        <root>/environment/<env>/{sparse/0/*.bin, gs/point_cloud/iteration_30000/point_cloud.ply}
        <root>/object/<name>/fused/gs/point_cloud/iteration_30000/point_cloud.ply
        <root>/urdf/{<name>.obj, <name>.urdf}
    """
    from pegasus_tpu_torch.gs.ply import save_gs_ply
    from pegasus_tpu_torch.io import colmap as colmap_io
    from pegasus_tpu_torch.io.mesh import TriMesh, save_obj
    from pegasus_tpu_torch.physics.urdf import generate_urdf

    rng = rng or np.random.default_rng(0)
    root = Path(root)

    # environment: plane cloud + colmap hemisphere
    env_dir = root / "environment" / env_name
    # host-side: these clouds only go to PLY files
    env_cloud = make_plane_cloud(rng, n=env_splats, size=2.0, device="cpu")
    save_gs_ply(
        env_cloud,
        env_dir / "gs" / "point_cloud" / "iteration_30000" / "point_cloud.ply",
    )
    cams, images = make_colmap_hemisphere(
        n_images=n_colmap_images, radius=1.4, target=(0, 0, 0.05)
    )
    sparse = env_dir / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    colmap_io.write_cameras_binary(cams, sparse / "cameras.bin")
    colmap_io.write_images_binary(images, sparse / "images.bin")
    colmap_io.write_points3d_binary({}, sparse / "points3D.bin")

    # env mesh + urdf (flat box under the plane)
    verts, faces = make_box_mesh(half_extents=(1.0, 1.0, 0.005), center=(0, 0, -0.005))
    save_obj(TriMesh(verts, faces), root / "urdf" / f"{env_name}.obj")
    generate_urdf(
        root / "urdf" / f"{env_name}.urdf",
        mesh_filename=f"{env_name}.obj",
        name=env_name,
        mass=0.0,
        center_of_mass=(0, 0, 0),
        mesh_extents=(2.0, 2.0, 0.01),
        static=True,
    )

    # objects: boxes with distinct colors
    palette = [(0.8, 0.2, 0.2), (0.2, 0.4, 0.8), (0.9, 0.7, 0.1), (0.3, 0.8, 0.3)]
    for i, name in enumerate(object_names):
        half = (0.04, 0.04, 0.06)
        cloud = make_box_cloud(
            rng, n=obj_splats, half_extents=half, center=(0, 0, 0), rgb=palette[i % 4],
            object_id=0, device="cpu",
        )
        save_gs_ply(
            cloud,
            root / "object" / name / "fused" / "gs" / "point_cloud"
            / "iteration_30000" / "point_cloud.ply",
        )
        verts, faces = make_box_mesh(half_extents=half)
        save_obj(TriMesh(verts, faces), root / "urdf" / f"{name}.obj")
        generate_urdf(
            root / "urdf" / f"{name}.urdf",
            mesh_filename=f"{name}.obj",
            name=name,
            mass=0.2,
            center_of_mass=(0, 0, 0),
            mesh_extents=tuple(2 * h for h in half),
        )
    return root
