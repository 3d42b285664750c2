"""Frozen copy of pegasus_tpu_torch/io/mesh.py at commit 7a69f88.

Copied verbatim from ``pegasus_tpu/io/mesh.py``; only the import lines differ.

Triangle-mesh I/O and geometry queries, replacing open3d usage.

The reference leans on open3d for mesh reading, AABB/OBB, diameter and
uniform sampling (reference: src/tools/pegasus_bop.py:385-410, 452-570).
This module provides the same quantities with numpy/scipy only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from scipy.spatial import ConvexHull


@dataclass
class TriMesh:
    vertices: np.ndarray  # [V, 3] float64
    faces: np.ndarray  # [F, 3] int32

    # -- geometry ------------------------------------------------------------

    def aabb(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def get_center(self) -> np.ndarray:
        """Mean of vertices (open3d TriangleMesh.get_center semantics)."""
        return self.vertices.mean(axis=0)

    def diameter(self) -> float:
        """Max pairwise vertex distance.

        The reference computes this O(V^2) over all vertices
        (src/tools/pegasus_bop.py:371-383); the max pairwise distance is
        attained on the convex hull, so we reduce to hull vertices first —
        identical value, orders of magnitude faster.
        """
        pts = self.vertices
        if len(pts) > 12:
            try:
                hull = ConvexHull(pts)
                pts = pts[hull.vertices]
            except Exception:
                pass
        d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
        return float(np.sqrt(d2.max()))

    def oriented_bounding_box(self):
        """(R [3,3], center [3], half_extents [3]) PCA-based minimal-ish OBB.

        Stands in for open3d's get_minimal_oriented_bounding_box
        (reference: src/tools/pegasus_bop.py:465); PCA over hull vertices is
        the standard approximation (exact O'Rourke is not needed for GT
        boxes; the BOP gt consumers use the 8 corners + projection only).
        """
        pts = self.vertices
        try:
            hull = ConvexHull(pts)
            hp = pts[hull.vertices]
        except Exception:
            hp = pts
        c = hp.mean(axis=0)
        cov = np.cov((hp - c).T)
        _, vecs = np.linalg.eigh(cov)
        R = vecs[:, ::-1]  # principal axes, descending variance
        if np.linalg.det(R) < 0:
            R[:, 2] *= -1
        local = (pts - c) @ R
        lo, hi = local.min(axis=0), local.max(axis=0)
        center = c + R @ ((lo + hi) / 2)
        half = (hi - lo) / 2
        return R, center, half

    def obb_corners(self) -> np.ndarray:
        """8 OBB corners in open3d's get_box_points ordering:
        index bit-pattern corners [c±x±y±z] ordered as open3d returns them
        (000,100,010,001,110,101,011,111 signs over -,+)."""
        R, center, half = self.oriented_bounding_box()
        signs = np.array(
            [
                [-1, -1, -1],
                [1, -1, -1],
                [-1, 1, -1],
                [-1, -1, 1],
                [1, 1, 1],
                [-1, 1, 1],
                [1, -1, 1],
                [1, 1, -1],
            ],
            np.float64,
        )
        return center + (signs * half) @ R.T

    def sample_points(self, n: int, rng=None) -> np.ndarray:
        """Uniform surface sampling (open3d sample_points_uniformly)."""
        rng = rng or np.random.default_rng(0)
        v = self.vertices
        f = self.faces
        tri = v[f]  # [F, 3, 3]
        areas = 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
        )
        probs = areas / areas.sum()
        idx = rng.choice(len(f), size=n, p=probs)
        u = rng.uniform(size=(n, 1))
        w = rng.uniform(size=(n, 1))
        flip = (u + w) > 1
        u = np.where(flip, 1 - u, u)
        w = np.where(flip, 1 - w, w)
        t = tri[idx]
        return t[:, 0] + u * (t[:, 1] - t[:, 0]) + w * (t[:, 2] - t[:, 0])

    def scaled(self, s: float) -> "TriMesh":
        return TriMesh(self.vertices * s, self.faces)


# -- OBJ ----------------------------------------------------------------------


def load_obj(path) -> TriMesh:
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:]]
                idx = [int(i) for i in idx]
                # triangulate fans; handle negative indices
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(
        np.asarray(verts, np.float64), np.asarray(faces, np.int32).reshape(-1, 3)
    )


def save_obj(mesh: TriMesh, path) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


# -- mesh PLY (BOP models are ascii PLY meshes) --------------------------------


def save_mesh_ply(mesh: TriMesh, path, ascii: bool = True) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
    v, f = mesh.vertices, mesh.faces
    header = [
        "ply",
        "format ascii 1.0" if ascii else "format binary_little_endian 1.0",
        f"element vertex {len(v)}",
        "property float x",
        "property float y",
        "property float z",
        f"element face {len(f)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    if ascii:
        with open(path, "w") as out:
            out.write("\n".join(header) + "\n")
            for p in v:
                out.write(f"{p[0]} {p[1]} {p[2]}\n")
            for face in f:
                out.write(f"3 {face[0]} {face[1]} {face[2]}\n")
    else:
        with open(path, "wb") as out:
            out.write(("\n".join(header) + "\n").encode())
            out.write(v.astype("<f4").tobytes())
            rec = np.zeros(len(f), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = 3
            rec["idx"] = f
            out.write(rec.tobytes())


def load_mesh_ply(path) -> TriMesh:
    """Minimal ascii/binary mesh PLY reader (vertex xyz + face lists)."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError("not a PLY")
        fmt = None
        elements = []  # (name, count, props)
        props = None
        while True:
            tokens = fh.readline().strip().split()
            if not tokens:
                continue
            key = tokens[0].decode()
            if key == "format":
                fmt = tokens[1].decode()
            elif key == "element":
                props = []
                elements.append((tokens[1].decode(), int(tokens[2]), props))
            elif key == "property":
                props.append([t.decode() for t in tokens[1:]])
            elif key == "end_header":
                break
        verts = None
        faces = []
        if fmt == "ascii":
            lines = fh.read().decode().split("\n")
            cursor = 0
            for name, count, eprops in elements:
                chunk = lines[cursor : cursor + count]
                cursor += count
                if name == "vertex":
                    verts = np.array(
                        [[float(x) for x in ln.split()[:3]] for ln in chunk]
                    )
                elif name == "face":
                    for ln in chunk:
                        parts = [int(x) for x in ln.split()]
                        k = parts[0]
                        idx = parts[1 : 1 + k]
                        for j in range(1, k - 1):
                            faces.append([idx[0], idx[j], idx[j + 1]])
        else:
            type_map = {
                "float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
                "uint": "<u4", "short": "<i2", "ushort": "<u2", "char": "i1",
            }
            for name, count, eprops in elements:
                if name == "vertex":
                    dt = np.dtype(
                        [(p[1], type_map[p[0]]) for p in eprops if p[0] != "list"]
                    )
                    data = np.frombuffer(fh.read(dt.itemsize * count), dtype=dt)
                    verts = np.stack(
                        [data["x"], data["y"], data["z"]], axis=1
                    ).astype(np.float64)
                elif name == "face":
                    cnt_t = type_map[eprops[0][1]]
                    idx_t = type_map[eprops[0][2]]
                    cnt_size = np.dtype(cnt_t).itemsize
                    idx_size = np.dtype(idx_t).itemsize
                    for _ in range(count):
                        k = int(np.frombuffer(fh.read(cnt_size), dtype=cnt_t)[0])
                        idx = np.frombuffer(fh.read(idx_size * k), dtype=idx_t)
                        for j in range(1, k - 1):
                            faces.append([idx[0], idx[j], idx[j + 1]])
    return TriMesh(verts, np.asarray(faces, np.int32).reshape(-1, 3))


def load_mesh(path) -> TriMesh:
    p = str(path)
    if p.endswith(".obj"):
        return load_obj(p)
    if p.endswith(".ply"):
        return load_mesh_ply(p)
    raise ValueError(f"unsupported mesh format: {p}")
