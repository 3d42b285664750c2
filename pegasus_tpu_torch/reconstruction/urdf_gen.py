"""Copied from ``pegasus_tpu/reconstruction/urdf_gen.py``; the import lines differ, and ``gs_cleaning`` loads the cloud onto ``device``.

Alpha-shape meshing + URDF generation for physics assets.

Rebuild of the missing ``data_urdf.URDFGenerator`` (contract: SURVEY 2.3.3,
object_reconstruction.py:206-221, README.md:185): turn a trained GS point
cloud into a watertight-ish collision mesh via a 3D alpha shape, write the
.obj + a single-link URDF whose inertial origin is the center of mass, and
expose the recentering transform used to clean the GS ply afterwards
(``gs_cleaning``).

The alpha shape replaces open3d's
create_from_point_cloud_alpha_shape: Delaunay tetrahedralization
(scipy.spatial), keep tetrahedra with circumradius <= alpha, surface =
faces incident to exactly one kept tetrahedron.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial import Delaunay

from pegasus_tpu_torch.device import DEFAULT_DEVICE
from pegasus_tpu_torch.io.mesh import TriMesh, save_obj
from pegasus_tpu_torch.physics.urdf import generate_urdf


def _tet_circumradius(pts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Circumradius of each tetrahedron [T, 4] over points [N, 3]."""
    a = pts[tets[:, 0]]
    b = pts[tets[:, 1]] - a
    c = pts[tets[:, 2]] - a
    d = pts[tets[:, 3]] - a
    # circumcenter relative to a: solve 2 [b; c; d] x = [|b|^2; |c|^2; |d|^2]
    A = np.stack([b, c, d], axis=1)  # [T, 3, 3]
    rhs = np.stack(
        [np.sum(b * b, 1), np.sum(c * c, 1), np.sum(d * d, 1)], axis=1
    )
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-14
    x = np.zeros((len(tets), 3))
    if ok.any():
        x[ok] = np.linalg.solve(2.0 * A[ok], rhs[ok][..., None])[..., 0]
    r = np.linalg.norm(x, axis=1)
    r[~ok] = np.inf
    return r


def alpha_shape_mesh(points: np.ndarray, alpha: float) -> TriMesh:
    """3D alpha-shape surface of a point cloud."""
    points = np.asarray(points, np.float64)
    tri = Delaunay(points)
    tets = tri.simplices  # [T, 4]
    radii = _tet_circumradius(points, tets)
    kept = tets[radii <= alpha]
    if len(kept) == 0:
        raise ValueError(
            f"alpha={alpha} keeps no tetrahedra; increase alpha "
            f"(median circumradius {np.median(radii[np.isfinite(radii)]):.4f})"
        )
    # boundary faces: appear in exactly one kept tet
    faces = np.concatenate(
        [
            kept[:, [0, 1, 2]],
            kept[:, [0, 1, 3]],
            kept[:, [0, 2, 3]],
            kept[:, [1, 2, 3]],
        ]
    )
    key = np.sort(faces, axis=1)
    _, idx, counts = np.unique(
        key, axis=0, return_index=True, return_counts=True
    )
    boundary = faces[idx[counts == 1]]
    # compact vertices
    used = np.unique(boundary)
    remap = np.full(len(points), -1, np.int64)
    remap[used] = np.arange(len(used))
    return TriMesh(points[used], remap[boundary].astype(np.int32))


class URDFGenerator:
    """GS point cloud -> collision mesh (.obj) + URDF
    (ctor contract: SURVEY 2.3.3)."""

    def __init__(
        self,
        object_path,
        urdf_template=None,  # templates are builtin (physics/urdf.py)
        object_type: str = "object",
        meta_info=None,
        ycb_path=None,
        mass: float = 0.2,
    ):
        self.object_path = Path(object_path)
        self.object_type = object_type
        self.meta_info = meta_info
        self.mass = mass
        self.center_translation = np.zeros(3)
        self.center_rotation = np.eye(3)

    def _load_points(self) -> np.ndarray:
        from pegasus_tpu_torch.gs.ply import read_ply_vertex_data

        v = read_ply_vertex_data(str(self.object_path))
        return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)

    def generate(self, obj_path, urdf_path, alpha: float = 0.05) -> TriMesh:
        """Mesh the cloud, recenter it at its center of mass, write
        .obj + .urdf.  The recentering transform is exposed as
        center_translation/center_rotation for gs_cleaning
        (reference usage: object_reconstruction.py:211-221)."""
        pts = self._load_points()
        mesh = alpha_shape_mesh(pts, alpha)

        com = mesh.vertices.mean(axis=0)
        if self.object_type == "environment":
            # environments stay world-anchored (plane-aligned already)
            com = np.zeros(3)
        mesh = TriMesh(mesh.vertices - com, mesh.faces)
        self.center_translation = -com
        self.center_rotation = np.eye(3)

        save_obj(mesh, obj_path)
        lo, hi = mesh.aabb()
        generate_urdf(
            urdf_path,
            mesh_filename=Path(obj_path).name,
            name=Path(obj_path).stem,
            mass=self.mass,
            center_of_mass=(0.0, 0.0, 0.0),
            mesh_extents=hi - lo,
            static=self.object_type == "environment",
        )
        return mesh


def gs_cleaning(ply_path, t, R, out_path=None, device=DEFAULT_DEVICE) -> None:
    """Recenter a trained GS ply by the URDF recentering transform
    (asset-class contract ``gs_cleaning(t, R)``, SURVEY 2.3.2), on
    ``device``."""
    from pegasus_tpu_torch.gs.ply import load_gs_ply, save_gs_ply

    cloud = load_gs_ply(str(ply_path), device=device)
    cloud = cloud.transformed(np.asarray(R), np.asarray(t), pivot="origin")
    save_gs_ply(cloud, str(out_path or ply_path))
