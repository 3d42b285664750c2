"""Copied verbatim from ``pegasus_tpu/reconstruction/alignment.py``; only the import lines differ.

Reconstruction-to-ground alignment.

Rebuild of the missing ``data_alignment.ReconstructionAlignment``
(contract: SURVEY 2.3.3, environment_reconstruction.py:61-66): fit the
dominant plane of the sparse point cloud, rotate the world so the plane
normal is +z and the plane sits at z = 0.  This invariant is what lets
PEGASUS physics use a z=0 ground plane for every environment.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pegasus_tpu_torch.io import colmap as cio
from pegasus_tpu_torch.utils.pose import qvec2rotmat, rotmat2qvec


def fit_plane_ransac(
    points: np.ndarray,
    n_iters: int = 500,
    inlier_thresh: float = 0.01,
    rng=None,
):
    """(normal [3], d) of the dominant plane n.x + d = 0 via RANSAC."""
    rng = rng or np.random.default_rng(0)
    best_inliers = -1
    best = (np.array([0, 0, 1.0]), 0.0)
    n_pts = len(points)
    if n_pts < 3:
        return best
    for _ in range(n_iters):
        idx = rng.choice(n_pts, 3, replace=False)
        p0, p1, p2 = points[idx]
        n = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(n)
        if norm < 1e-12:
            continue
        n = n / norm
        d = -n @ p0
        inliers = int(np.sum(np.abs(points @ n + d) < inlier_thresh))
        if inliers > best_inliers:
            best_inliers = inliers
            best = (n, d)
    # refine on inliers
    n, d = best
    mask = np.abs(points @ n + d) < inlier_thresh
    if mask.sum() >= 3:
        sel = points[mask]
        centroid = sel.mean(0)
        _, _, vt = np.linalg.svd(sel - centroid)
        n = vt[2]
        d = -n @ centroid
    return n, d


class ReconstructionAlignment:
    """Aligns a COLMAP sparse model so its dominant plane is z=0."""

    def __init__(self, sparse_dir, plane_normal=(0, 0, 1.0)):
        self.sparse_dir = Path(sparse_dir)
        self.plane_normal = np.asarray(plane_normal, np.float64)
        self.images = cio.read_images_binary(self.sparse_dir / "images.bin")
        pts_path = self.sparse_dir / "points3D.bin"
        self.points = (
            cio.read_points3d_binary(pts_path) if pts_path.exists() else {}
        )
        self.T = np.eye(4)
        self.plane_mesh = None  # (vertices, faces) of the fitted plane patch

    def align2plane(self, plane_size: float = 2.0, debug: bool = False):
        pts = np.stack([p.xyz for p in self.points.values()])
        n, d = fit_plane_ransac(pts)

        # orient the normal toward the median camera side (cameras above)
        centers = np.stack(
            [-qvec2rotmat(im.qvec).T @ im.tvec for im in self.images.values()]
        )
        if np.median(centers @ n + d) < 0:
            n, d = -n, -d

        target = self.plane_normal / np.linalg.norm(self.plane_normal)
        v = np.cross(n, target)
        c = float(n @ target)
        if np.linalg.norm(v) < 1e-12:
            R = np.eye(3) if c > 0 else -np.eye(3)
        else:
            vx = np.array(
                [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
            )
            R = np.eye(3) + vx + vx @ vx * ((1 - c) / (v @ v))

        # plane point closest to origin maps to z = 0
        p0 = -d * n
        t = -R @ p0
        self.T = np.eye(4)
        self.T[:3, :3] = R
        self.T[:3, 3] = t
        self._apply(R, t)

        half = plane_size / 2
        verts = np.array(
            [[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]]
        )
        self.plane_mesh = (verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
        return self.T

    def _apply(self, R: np.ndarray, t: np.ndarray) -> None:
        """x' = R x + t on points; w2c' = w2c composed with the inverse."""
        for p in self.points.values():
            p.xyz = R @ p.xyz + t
        for im in self.images.values():
            R_w2c = qvec2rotmat(im.qvec)
            t_w2c = np.asarray(im.tvec)
            R_new = R_w2c @ R.T
            t_new = t_w2c - R_new @ t
            im.qvec = rotmat2qvec(R_new)
            im.tvec = t_new

    def save(self) -> None:
        cio.write_images_binary(self.images, self.sparse_dir / "images.bin")
        if self.points:
            cio.write_points3d_binary(
                self.points, self.sparse_dir / "points3D.bin"
            )

    def visualize(
        self,
        add_object=None,
        coord_system: bool = False,
        save_path=None,
        show: bool = False,
    ):
        """Diagnostic view of the aligned reconstruction (the reference's
        open3d window, data_alignment contract at
        environment_reconstruction.py:61-66) — headless-first: sparse
        points, fitted plane and camera centers are drawn with matplotlib
        and saved to ``save_path`` (default: <sparse_dir>/alignment.png).
        Set show=True for an interactive window where a display exists.
        Returns the saved path."""
        import matplotlib

        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")

        if self.points:
            xyz = np.stack([p.xyz for p in self.points.values()])
            rgb = np.stack(
                [getattr(p, "rgb", np.array([128, 128, 128]))
                 for p in self.points.values()]
            ).astype(np.float32) / 255.0
            step = max(1, len(xyz) // 20_000)
            ax.scatter(*xyz[::step].T, c=rgb[::step], s=1, alpha=0.6)

        centers = []
        for im in self.images.values():
            R_w2c = qvec2rotmat(im.qvec)
            centers.append(-R_w2c.T @ np.asarray(im.tvec))
        if centers:
            centers = np.stack(centers)
            ax.scatter(*centers.T, c="tab:red", s=14, marker="^",
                       label="cameras")

        if getattr(self, "plane_mesh", None) is not None:
            verts, _ = self.plane_mesh
            quad = np.vstack([verts, verts[:1]])
            ax.plot(*quad.T, c="tab:blue", label="fitted plane (z=0)")

        if coord_system:
            for axis, color in zip(np.eye(3) * 0.3, ("r", "g", "b")):
                ax.plot([0, axis[0]], [0, axis[1]], [0, axis[2]], c=color)

        if add_object is not None and hasattr(add_object, "vertices"):
            v = np.asarray(add_object.vertices)
            step = max(1, len(v) // 5000)
            ax.scatter(*v[::step].T, c="tab:green", s=2, label="object")

        ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
        ax.legend(loc="upper right")
        path = Path(save_path) if save_path else self.sparse_dir / "alignment.png"
        if show:
            plt.show()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
