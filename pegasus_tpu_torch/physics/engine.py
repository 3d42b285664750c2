"""Drop-simulation engine with the reference's PybulletEngine surface.

Port of ``pegasus_tpu/physics/engine.py``: construct with URDF asset
folder(s), ``add_object`` per asset, ``simulate()`` writes the trajectory
JSON (same schema, so either engine's output replays identically).  The
geometry preparation (collision points, hull planes and edges, approximate
convex decomposition, the per-asset cache) is host work in numpy and scipy,
copied from the reference with only its import lines changed; the stepper
is ``pegasus_tpu_torch.physics.rigid_body`` on one torch device.

Beyond the reference's engine: ``simulate_variants(n)`` runs n randomized
drops of the same scene as ONE batched program.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Union

import numpy as np
import torch

from pegasus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pegasus_tpu_torch.io.mesh import load_mesh
from pegasus_tpu_torch.physics import rigid_body as rb
from pegasus_tpu_torch.physics.heightfield import Heightfield, bake_heightfield
from pegasus_tpu_torch.physics.urdf import box_inertia, parse_urdf
from pegasus_tpu_torch.scene.trajectory import AssetInfo, Trajectory
from pegasus_tpu_torch.utils import quaternion as quat

MAX_BODIES = 8
MAX_POINTS = 48
MAX_HULL_PLANES = 48
MAX_HULL_PARTS = 6
MAX_EDGES = 24
CONCAVITY_THRESHOLD = 0.08  # fraction of diameter triggering decomposition


def _farthest_point_downsample(pts: np.ndarray, k: int) -> np.ndarray:
    if len(pts) <= k:
        return pts
    chosen = [int(np.argmax(np.linalg.norm(pts - pts.mean(0), axis=1)))]
    d = np.linalg.norm(pts - pts[chosen[0]], axis=1)
    for _ in range(k - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(pts - pts[nxt], axis=1))
    return pts[chosen]


def collision_points_from_mesh(verts: np.ndarray, k: int = MAX_POINTS,
                               faces: np.ndarray | None = None) -> np.ndarray:
    """Contact-point cloud: hull vertices PLUS surface samples, FPS to k.

    Corners alone cannot support face-face contact (aligned stacked boxes:
    every corner sits on the other box's lateral boundary, so the
    min-penetration normals point sideways and cancel); surface samples in
    face interiors provide the vertical support points."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(verts, np.float64)
    hull_pts = pts
    if len(pts) > 16:
        try:
            hull_pts = pts[ConvexHull(pts).vertices]
        except Exception:
            hull_pts = pts
    extra = []
    if faces is not None and len(faces):
        from pegasus_tpu_torch.io.mesh import TriMesh

        mesh = TriMesh(pts, np.asarray(faces, np.int32))
        extra.append(mesh.sample_points(4 * k, rng=np.random.default_rng(0)))
    cand = np.concatenate([hull_pts] + extra, axis=0) if extra else hull_pts
    return _farthest_point_downsample(cand, k)


def hull_planes_from_mesh(
    verts: np.ndarray, k: int = MAX_HULL_PLANES
) -> tuple[np.ndarray, np.ndarray]:
    """Convex-hull half-space set (n [k,3], d [k]; inside iff n.x <= d).

    The pair narrow phase collides contact points against these facets —
    the hull-level fidelity Bullet gets from loadURDF's convex collision
    (reference: physical_simulation.py:77).  If the hull has more than k
    facets, the k most direction-diverse ones are kept (dropping facets
    only makes the proxy slightly larger — conservative).  Padding facets
    use d=1e9 so they never bind.
    """
    from scipy.spatial import ConvexHull

    pts = np.asarray(verts, np.float64)
    n_pad = np.tile(np.array([0.0, 0.0, 1.0]), (k, 1))
    d_pad = np.full(k, 1e9)
    try:
        hull = ConvexHull(pts)
    except Exception:
        lo, hi = pts.min(0), pts.max(0)
        he = np.maximum((hi - lo) / 2.0, 1e-4)
        c = (hi + lo) / 2.0
        eye = np.eye(3)
        n = np.concatenate([eye, -eye], axis=0)
        d = np.concatenate([he + eye @ c, he - eye @ c])
        n_pad[:6], d_pad[:6] = n, d
        return n_pad.astype(np.float32), d_pad.astype(np.float32)

    eq = hull.equations  # n.x + b <= 0 inside, |n| = 1
    n, d = eq[:, :3], -eq[:, 3]
    key = np.round(np.concatenate([n, d[:, None]], axis=1), 4)
    _, uniq = np.unique(key, axis=0, return_index=True)
    n, d = n[uniq], d[uniq]
    if len(n) > k:
        sel = [int(np.argmax(d))]
        dist = np.linalg.norm(n - n[sel[0]], axis=1)
        for _ in range(k - 1):
            nxt = int(np.argmax(dist))
            sel.append(nxt)
            dist = np.minimum(dist, np.linalg.norm(n - n[nxt], axis=1))
        n, d = n[sel], d[sel]
    n_pad[: len(n)], d_pad[: len(n)] = n, d
    return n_pad.astype(np.float32), d_pad.astype(np.float32)


def hull_edges_from_mesh(
    verts: np.ndarray, k: int = MAX_EDGES
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convex-hull edge segments (a [k,3], b [k,3], mask [k]) for the
    edge-edge narrow phase (rigid_body._edge_manifold).  Edges between
    near-coplanar facets are dropped (they are face interiors, owned by
    the point pass); if more remain than k, the LONGEST are kept — long
    edges are the ones a crossing contact can bridge between sampled
    points; short ones are locally covered by the contact-point cloud."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(verts, np.float64)
    a_pad = np.zeros((k, 3), np.float32)
    b_pad = np.zeros((k, 3), np.float32)
    mask = np.zeros(k, bool)

    def _aabb_box_edges():
        # degenerate hull: the 12 AABB edges (mirrors the box fallback
        # hull_planes_from_mesh uses, so planes and edges stay consistent)
        lo, hi = pts.min(0), pts.max(0)
        he = np.maximum((hi - lo) / 2.0, 1e-4)
        c = (hi + lo) / 2.0
        signs = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float64,
        )
        corners = c + signs * he
        eidx = [
            (a, d) for a in range(8) for d in range(a + 1, 8)
            if bin(a ^ d).count("1") == 1
        ]
        kk = min(k, len(eidx))
        for m_i, (ai, bi) in enumerate(eidx[:kk]):
            a_pad[m_i], b_pad[m_i] = corners[ai], corners[bi]
        mask[:kk] = True
        return a_pad, b_pad, mask

    try:
        hull = ConvexHull(pts)
    except Exception:
        return _aabb_box_edges()
    # each hull edge is shared by two simplices; collect with facet normals
    edge_faces: dict[tuple[int, int], list[int]] = {}
    for f, simplex in enumerate(hull.simplices):
        m = len(simplex)
        for i in range(m):
            e = tuple(sorted((int(simplex[i]), int(simplex[(i + 1) % m]))))
            edge_faces.setdefault(e, []).append(f)
    normals = hull.equations[:, :3]
    edges = []
    for (i, j), faces in edge_faces.items():
        if len(faces) == 2:
            dihedral = float(np.dot(normals[faces[0]], normals[faces[1]]))
            if dihedral > 0.985:  # < ~10 deg crease: coplanar face interior
                continue
        edges.append((i, j))
    if not edges:
        return _aabb_box_edges()
    seg = pts[np.asarray(edges)]  # [n, 2, 3]
    lengths = np.linalg.norm(seg[:, 1] - seg[:, 0], axis=1)
    order = np.argsort(-lengths)[:k]
    seg = seg[order]
    n = len(seg)
    a_pad[:n] = seg[:, 0]
    b_pad[:n] = seg[:, 1]
    mask[:n] = True
    return a_pad, b_pad, mask


def _hull_planes_raw(pts: np.ndarray):
    from scipy.spatial import ConvexHull

    eq = ConvexHull(pts).equations
    n, d = eq[:, :3], -eq[:, 3]
    key = np.round(np.concatenate([n, d[:, None]], axis=1), 4)
    _, uniq = np.unique(key, axis=0, return_index=True)
    return n[uniq], d[uniq]


def _concavity(samples: np.ndarray, n: np.ndarray, d: np.ndarray) -> float:
    """Max inward distance of SURFACE samples from the hull boundary —
    ~0 for convex shapes, large for bowls/channels."""
    inward = d[None, :] - samples @ n.T  # [S, F] distance to each facet
    return float(np.min(inward, axis=1).max())


def _kmeans(pts: np.ndarray, k: int, iters: int = 12, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = pts[rng.choice(len(pts), k, replace=False)]
    for _ in range(iters):
        assign = np.argmin(
            np.linalg.norm(pts[:, None, :] - centers[None], axis=-1), axis=1
        )
        for c in range(k):
            sel = pts[assign == c]
            if len(sel):
                centers[c] = sel.mean(axis=0)
    return assign


def decompose_mesh_hulls(
    verts: np.ndarray,
    faces,
    max_parts: int = MAX_HULL_PARTS,
    max_planes: int = MAX_HULL_PLANES,
    concavity_threshold: float = CONCAVITY_THRESHOLD,
    n_samples: int = 2048,
):
    """Approximate convex decomposition -> grouped half-space sets.

    Bullet's default loadURDF collides the single convex hull (concave
    objects like bowls are 'filled in'); this EXCEEDS that: if surface
    samples sit deeper than ``concavity_threshold x diameter`` inside the
    hull, the surface is k-means-partitioned and each part gets its own
    hull, so objects can rest INSIDE concavities.  Returns
    (plane_n [max_planes,3], plane_d [max_planes], plane_group
    [max_planes], n_parts).
    """
    pts = np.asarray(verts, np.float64)
    group_pad = np.zeros(max_planes, np.int32)
    if faces is None or len(pts) < 4:
        n, d = hull_planes_from_mesh(pts, max_planes)
        return n, d, group_pad, 1

    from pegasus_tpu_torch.io.mesh import TriMesh

    mesh = TriMesh(pts, np.asarray(faces, np.int32))
    samples = np.concatenate(
        [mesh.sample_points(n_samples, rng=np.random.default_rng(0)), pts],
        axis=0,
    )
    diameter = float(np.linalg.norm(pts.max(0) - pts.min(0)))

    def union_concavity(parts):
        """Max depth of any SURFACE sample inside the union of part hulls
        — ~0 when the decomposition hugs the true surface; large when a
        part's hull bulges into a cavity (captures base-cluster hulls
        that would 'fill' a bowl)."""
        depth = np.zeros(len(samples))
        for pn, pd in parts:
            pen = pd[None, :] - samples @ pn.T  # [S, F]
            inside = np.all(pen > 1e-9, axis=1)
            depth = np.maximum(depth, np.where(inside, pen.min(axis=1), 0.0))
        return float(depth.max())

    try:
        n1, d1 = _hull_planes_raw(samples)
    except Exception:
        n, d = hull_planes_from_mesh(pts, max_planes)
        return n, d, group_pad, 1
    if _concavity(samples, n1, d1) < concavity_threshold * diameter:
        n, d = hull_planes_from_mesh(pts, max_planes)
        return n, d, group_pad, 1

    best = None  # (union_concavity, k, clusters)
    for k in range(2, max_parts + 1):
        assign = _kmeans(samples, k, seed=k)
        parts = []
        clusters = []
        ok = True
        for c in range(k):
            part = samples[assign == c]
            if len(part) < 4:
                ok = False
                break
            try:
                parts.append(_hull_planes_raw(part))
            except Exception:
                ok = False
                break
            clusters.append(part)
        if not ok:
            continue
        uc = union_concavity(parts)
        if best is None or uc < best[0]:
            best = (uc, k, clusters)
        if uc < concavity_threshold * diameter:
            break

    if best is None:
        n, d = hull_planes_from_mesh(pts, max_planes)
        return n, d, group_pad, 1

    _, k, clusters = best
    budget = max_planes // k
    n_pad = np.tile(np.array([0.0, 0.0, 1.0]), (max_planes, 1)).astype(np.float32)
    d_pad = np.full(max_planes, 1e9, np.float32)
    for c, part in enumerate(clusters):
        pn, pd = hull_planes_from_mesh(part, budget)
        lo, hi = c * budget, (c + 1) * budget
        n_pad[lo:hi], d_pad[lo:hi] = pn, pd
        group_pad[lo:hi] = c
    return n_pad, d_pad, group_pad, k


_ASSET_GEOMETRY_CACHE: dict = {}


def _normalize_quat_f32(q: np.ndarray) -> np.ndarray:
    """q / max(|q|, 1e-12) in float32, rounding as the reference's compiled
    ``normalize`` does on the CPU: the squares accumulate left to right
    through fused multiply-adds (one rounding per term), which float64
    holds exactly enough to reproduce, so that both engines start a drop
    from the same bits."""
    q = np.asarray(q, np.float32)
    acc = q[..., 0] * q[..., 0]
    for k in range(1, q.shape[-1]):
        term = q[..., k].astype(np.float64)
        acc = (term * term + acc.astype(np.float64)).astype(np.float32)
    norm = np.maximum(np.sqrt(acc), np.float32(1e-12))
    return q / norm[..., None]


def _asset_geometry(urdf_path: Path, obj_type: str, max_points: int,
                    max_edges: int, max_hull_parts: int,
                    max_hull_planes: int) -> dict:
    """Deterministic per-asset collision geometry, memoized process-wide.

    Everything here is a pure function of the URDF + mesh bytes and the
    engine's static capacity knobs (every sampler runs on a fixed seed),
    but it is expensive host work — 200k surface samples for the env
    heightfield, approximate convex decomposition, hull edge extraction —
    and generation constructs a fresh engine PER SCENE over the same few
    dozen assets.  Memoizing halves steady-state per-scene setup
    (profiled: bake_heightfield + sampling was 0.74 s of a 1.48 s setup).
    Keyed on the mtimes of both the URDF and its collision mesh so
    edited assets re-bake; cached arrays are frozen read-only so an
    accidental in-place mutation raises instead of corrupting every
    later scene sharing the asset.  The heightfield is baked onto the CPU:
    each engine moves it to its own device.
    """
    info = parse_urdf(urdf_path)
    mesh_path = (
        urdf_path.parent / info.collision_mesh if info.collision_mesh else None
    )
    has_mesh = mesh_path is not None and mesh_path.exists()
    key = (
        str(urdf_path), os.path.getmtime(urdf_path), obj_type,
        str(mesh_path), os.path.getmtime(mesh_path) if has_mesh else None,
        max_points, max_edges, max_hull_parts, max_hull_planes,
    )
    hit = _ASSET_GEOMETRY_CACHE.get(key)
    if hit is not None:
        return hit
    if has_mesh:
        mesh = load_mesh(mesh_path)
        verts = mesh.vertices * info.mesh_scale
        faces = mesh.faces
    else:
        verts = np.array([[0, 0, 0.0]])
        faces = None

    hf_applicable = obj_type == "environment" and has_mesh and len(verts) > 3
    heightfield = None
    if hf_applicable:
        try:
            heightfield = bake_heightfield(verts, faces, device="cpu")
        except Exception:
            heightfield = None

    pts = collision_points_from_mesh(verts, k=max_points, faces=faces)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    if obj_type == "object":
        edge_a, edge_b, edge_mask = hull_edges_from_mesh(verts, max_edges)
        plane_n, plane_d, plane_group, n_parts = decompose_mesh_hulls(
            verts, faces, max_parts=max_hull_parts, max_planes=max_hull_planes,
        )
    else:
        plane_n = plane_d = plane_group = None  # env: no pair contacts
        edge_a = edge_b = edge_mask = None
        n_parts = 1

    geom = dict(
        info=info,
        hf_applicable=hf_applicable,
        heightfield=heightfield,
        points=pts,
        lo=lo,
        hi=hi,
        plane_n=plane_n,
        plane_d=plane_d,
        plane_group=plane_group,
        edge_a=edge_a,
        edge_b=edge_b,
        edge_mask=edge_mask,
        n_parts=n_parts,
        radius=float(np.linalg.norm(pts, axis=1).max()),
    )
    for v in geom.values():  # freeze shared arrays (the heightfield's tensors stay on the CPU)
        if isinstance(v, np.ndarray):
            v.setflags(write=False)
    _ASSET_GEOMETRY_CACHE[key] = geom
    return geom


class PhysicsEngine:
    """Bullet-free drop simulation (reference ctor:
    physical_simulation.py:20-55)."""

    def __init__(
        self,
        asset_folder: Union[str, list],
        output_path_json: str = "simulation_steps.json",
        simulation_steps: int = 1000,
        gui: bool = False,  # accepted for API parity; no GUI here
        gravity=rb.DEFAULT_GRAVITY,
        dt: float = rb.DEFAULT_DT,
        seed: int | None = None,
        max_bodies: int = MAX_BODIES,
        max_points: int = MAX_POINTS,
        max_hull_planes: int = MAX_HULL_PLANES,
        max_hull_parts: int = MAX_HULL_PARTS,
        max_edges: int = MAX_EDGES,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.trajectory_path = Path(output_path_json)
        self.trajectory_path.parent.mkdir(exist_ok=True, parents=True)
        if isinstance(asset_folder, (str, Path)):
            self.asset_folders = [Path(asset_folder)]
        else:
            self.asset_folders = [Path(p) for p in asset_folder]
        self.simulation_steps = simulation_steps
        self.gravity = gravity
        self.dt = dt
        self.rng = np.random.default_rng(seed)

        self.max_bodies = max_bodies
        self.max_points = max_points
        self.max_hull_planes = max_hull_planes
        self.max_hull_parts = max_hull_parts
        self.max_edges = max_edges

        self.asset_list = {"environment": {}, "object": {}}
        self._bodies: List[dict] = []  # ordered by bullet id
        self.heightfield: Heightfield | None = None

    # -- reference API ---------------------------------------------------------

    def _resolve(self, name: str) -> Path:
        for folder in self.asset_folders:
            p = folder / name
            if p.exists():
                return p
        raise FileNotFoundError(f"{name} not found in {self.asset_folders}")

    def add_object(self, object_instance, start_pos=(0, 0, 0),
                   start_orientation_euler=(0, 0, 0)) -> int:
        """Mirror of PybulletEngine.add_object
        (reference: physical_simulation.py:57-96): environments load static
        with identity orientation; objects get a random UNNORMALIZED
        uniform(0,1)^4 start quaternion (the reference's distribution,
        physical_simulation.py:66-73 — normalized before integration, as
        Bullet does internally).  A NON-ZERO ``start_orientation_euler``
        overrides the random draw (the reference accepts the argument but
        its conversion is commented out, physical_simulation.py:62 —
        honoring it here is a documented improvement)."""
        name = object_instance.urdf_file_name
        obj_type = object_instance.TYPE
        class_name = object_instance.__class__.__name__
        obj_name = name.split(".")[0]
        body_id = len(self._bodies)

        urdf_path = self._resolve(name)
        geom = _asset_geometry(
            urdf_path, obj_type, self.max_points, self.max_edges,
            self.max_hull_parts, self.max_hull_planes,
        )
        info = geom["info"]

        if obj_type == "environment":
            q_xyzw = np.array([0.0, 0.0, 0.0, 1.0])
            self.asset_list["environment"][obj_name] = {
                "bullet_id": [body_id],
                "class_name": class_name,
            }
            mass = 0.0
            # the env collision mesh baked into a heightfield (relief-aware
            # ground contact; physics/heightfield.py)
            if geom["hf_applicable"]:
                hf = geom["heightfield"]
                self.heightfield = hf.to(self.device) if hf is not None else None
        elif obj_type == "object":
            euler = np.asarray(start_orientation_euler, np.float64)
            if np.any(euler != 0.0):
                from scipy.spatial.transform import Rotation as _Rot

                q_xyzw = _Rot.from_euler("xyz", euler).as_quat()
            else:
                q_xyzw = self.rng.uniform(0.0, 1.0, size=4)
            if obj_name not in self.asset_list["object"]:
                self.asset_list["object"][obj_name] = {
                    "bullet_id": [body_id],
                    "center_of_mass": [float(v) for v in info.center_of_mass],
                    "class_name": class_name,
                    "object_ID": getattr(object_instance, "ID", None),
                }
            else:
                self.asset_list["object"][obj_name]["bullet_id"].append(body_id)
            mass = info.mass if info.mass > 0 else 1.0
        else:
            raise ValueError(f"Wrong entity - {obj_type}")

        lo, hi = geom["lo"], geom["hi"]
        self._bodies.append(
            {
                "name": obj_name,
                "type": obj_type,
                "mass": mass,
                "points": geom["points"],
                "inertia": box_inertia(max(mass, 1e-6), hi - lo),
                "half_extents": (hi - lo) / 2.0,
                "plane_n": geom["plane_n"],
                "plane_d": geom["plane_d"],
                "plane_group": geom["plane_group"],
                "edge_a": geom["edge_a"],
                "edge_b": geom["edge_b"],
                "edge_mask": geom["edge_mask"],
                "n_parts": geom["n_parts"],
                "radius": geom["radius"],
                "start_pos": np.asarray(start_pos, np.float64),
                "start_q_xyzw": q_xyzw,
            }
        )
        return body_id

    # -- state assembly ----------------------------------------------------------

    def _build(self):
        b = len(self._bodies)
        nb, np_, nh = self.max_bodies, self.max_points, self.max_hull_planes
        if b > nb:
            raise ValueError(
                f"too many bodies: {b} > {nb} (raise max_bodies= on the engine)"
            )
        inv_mass = np.zeros(nb, np.float32)
        inv_inertia = np.zeros((nb, 3), np.float32)
        points = np.zeros((nb, np_, 3), np.float32)
        point_mask = np.zeros((nb, np_), bool)
        radius = np.zeros(nb, np.float32)
        half_extents = np.full((nb, 3), 1e-3, np.float32)
        plane_n = np.tile(np.array([0, 0, 1.0], np.float32), (nb, nh, 1))
        plane_d = np.full((nb, nh), 1e9, np.float32)
        plane_group = np.zeros((nb, nh), np.int32)
        ne = self.max_edges
        edge_a = np.zeros((nb, ne, 3), np.float32)
        edge_b = np.zeros((nb, ne, 3), np.float32)
        edge_mask = np.zeros((nb, ne), bool)
        friction = np.full(nb, 0.5, np.float32)
        restitution = np.zeros(nb, np.float32)
        body_mask = np.zeros(nb, bool)
        pos = np.zeros((nb, 3), np.float32)
        rot = np.tile(np.array([1.0, 0, 0, 0], np.float32), (nb, 1))

        for i, body in enumerate(self._bodies):
            body_mask[i] = True
            pos[i] = body["start_pos"]
            rot[i] = _normalize_quat_f32(np.roll(body["start_q_xyzw"], 1))
            if body["type"] == "object":
                inv_mass[i] = 1.0 / body["mass"]
                inv_inertia[i] = 1.0 / np.maximum(body["inertia"], 1e-9)
            n = len(body["points"])
            points[i, :n] = body["points"]
            point_mask[i, :n] = True
            radius[i] = body["radius"]
            half_extents[i] = body["half_extents"]
            if body.get("plane_n") is not None:
                plane_n[i] = body["plane_n"]
                plane_d[i] = body["plane_d"]
                plane_group[i] = body["plane_group"]
            if body.get("edge_a") is not None:
                edge_a[i] = body["edge_a"]
                edge_b[i] = body["edge_b"]
                edge_mask[i] = body["edge_mask"]

        dev = self.device
        t = lambda a: torch.tensor(a, device=dev)
        params = rb.RigidBodyParams(
            inv_mass=t(inv_mass),
            inv_inertia=t(inv_inertia),
            points=t(points),
            point_mask=t(point_mask),
            radius=t(radius),
            friction=t(friction),
            restitution=t(restitution),
            body_mask=t(body_mask),
            half_extents=t(half_extents),
            plane_n=t(plane_n),
            plane_d=t(plane_d),
            plane_group=t(plane_group),
            edge_a=t(edge_a),
            edge_b=t(edge_b),
            edge_mask=t(edge_mask),
            # specialize the unrolled group loop to what the scene needs:
            # all-convex scenes keep the single-group fast path
            num_hull_parts=max(
                (b.get("n_parts", 1) for b in self._bodies), default=1
            ),
        )
        # the reference normalises once here and once in ``rest``: both in
        # numpy, so that the start state holds the same bits on any device
        pos_t = t(pos)
        state0 = rb.RigidBodyState(
            pos=pos_t,
            rot=t(_normalize_quat_f32(rot)),
            linvel=torch.zeros_like(pos_t),
            angvel=torch.zeros_like(pos_t),
        )
        return params, state0

    # -- simulation ----------------------------------------------------------------

    def render_debug_camera(
        self,
        trajectory: Trajectory,
        every: int = 10,
        size: int = 128,
        out_dir=None,
    ) -> "np.ndarray":
        """Debug-camera frames of the simulation (the reference renders a
        128x128 ``p.getCameraImage`` EVERY step, physical_simulation.py:
        99-133; here it is opt-in and decoupled from stepping).

        Splats each body's collision points into a [T/every, size, size]
        grayscale z-buffer image from a fixed diagonal viewpoint; frames
        are optionally written as PNGs next to the trajectory JSON.
        """
        from pegasus_tpu_torch.utils.pose import qvec2rotmat

        times_t = np.asarray(trajectory.times_t)  # [B, T, 3]
        times_q = np.asarray(trajectory.times_q)  # [B, T, 4] xyzw
        n_bodies, n_steps = times_t.shape[:2]
        steps = range(0, n_steps, max(1, every))

        eye = np.array([0.8, 0.8, 0.6])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        f = size  # ~53 deg fov

        frames = np.zeros((len(steps), size, size), np.uint8)
        for fi, t in enumerate(steps):
            pts_w = []
            for b, body in enumerate(self._bodies[:n_bodies]):
                q = np.roll(times_q[b, t], 1)  # xyzw -> wxyz (qvec order)
                R = qvec2rotmat(q)
                pts_w.append(body["points"] @ R.T + times_t[b, t])
            pts = np.concatenate(pts_w, axis=0) - eye
            cam = np.stack([pts @ right, pts @ up, pts @ fwd], axis=1)
            z = cam[:, 2]
            vis = z > 1e-3
            u = (f * cam[vis, 0] / z[vis] + size / 2).astype(int)
            v = (size / 2 - f * cam[vis, 1] / z[vis]).astype(int)
            ok = (u >= 0) & (u < size) & (v >= 0) & (v < size)
            shade = np.clip(255 - 120 * z[vis][ok], 40, 255).astype(np.uint8)
            img = frames[fi]
            np.maximum.at(img, (v[ok], u[ok]), shade)
        if out_dir is not None:
            from pegasus_tpu_torch.io.png import write_png

            out = Path(out_dir)
            out.mkdir(parents=True, exist_ok=True)
            for fi in range(len(frames)):
                write_png(out / f"debug_{fi:04d}.png", frames[fi])
        return frames

    def _trajectory(self, times_t: np.ndarray, times_q: np.ndarray) -> Trajectory:
        """The scene's ``Trajectory`` (the trajectory JSON's content): the
        bodies' asset infos from ``asset_list`` and their motion, times_t
        [B, T, 3] and times_q [B, T, 4] xyzw."""
        env_name, env = next(iter(self.asset_list["environment"].items()))
        objects = {
            name: AssetInfo(name=name, class_name=d["class_name"], bullet_ids=d["bullet_id"],
                            object_ID=d.get("object_ID"), center_of_mass=d.get("center_of_mass"))
            for name, d in self.asset_list["object"].items()
        }
        return Trajectory(
            environment=AssetInfo(name=env_name, class_name=env["class_name"],
                                  bullet_ids=env["bullet_id"]),
            objects=objects, times_t=times_t, times_q=times_q,
        )

    def simulate(
        self, write_json: bool = True, debug_camera: bool = False
    ) -> Trajectory:
        """Run the drop and (like the reference, physical_simulation.py:98-170)
        dump the {asset_infos, trajectory} JSON keyed by bullet body id.

        debug_camera=True additionally writes 128x128 debug frames beside
        the trajectory JSON (reference behavior: always-on per-step
        getCameraImage; here opt-in, every 10th step)."""
        params, state0 = self._build()
        traj_states, _ = rb.simulate(
            params,
            state0,
            n_steps=self.simulation_steps,
            dt=self.dt,
            gravity=self.gravity,
            heightfield=self.heightfield,
            device=self.device,
        )
        n_bodies = len(self._bodies)
        pos = traj_states.pos.cpu().numpy()[:, :n_bodies]  # [T, B, 3]
        rot = traj_states.rot.cpu().numpy()[:, :n_bodies]  # [T, B, 4] wxyz

        times_t = np.transpose(pos, (1, 0, 2))
        times_q = np.roll(np.transpose(rot, (1, 0, 2)), -1, axis=-1)  # xyzw

        trajectory = self._trajectory(times_t, times_q)
        if write_json:
            trajectory.to_json(self.trajectory_path)
        if debug_camera:
            self.render_debug_camera(
                trajectory,
                out_dir=self.trajectory_path.parent
                / f"{self.trajectory_path.stem}_debug",
            )
        return trajectory

    def simulate_variants(self, n_variants: int, seed: int = 0,
                          generator: torch.Generator | None = None):
        """A batch of randomized re-drops of the registered scene as one
        program: the scene-level parallelism the reference's Bullet loop
        lacks.  The start orientations are uniform(0,1)^4 quaternions drawn
        on the CPU from ``generator`` (default: one seeded with ``seed``),
        so a seed means the same drops on any device.

        Returns stacked (pos [V, T, B, 3], rot_xyzw [V, T, B, 4]) as numpy.
        """
        params, state0 = self._build()
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        qs = torch.rand((n_variants, self.max_bodies, 4), generator=generator)
        qs = quat.normalize(qs).to(self.device)
        dyn = params.inv_mass > 0
        states = rb.RigidBodyState(
            pos=state0.pos.expand(n_variants, -1, -1),
            rot=torch.where(dyn[:, None], qs, state0.rot),
            linvel=state0.linvel.expand(n_variants, -1, -1),
            angvel=state0.angvel.expand(n_variants, -1, -1),
        )
        traj, _ = rb.simulate_batch(
            params, states, n_steps=self.simulation_steps,
            dt=self.dt, gravity=self.gravity,
            heightfield=self.heightfield, device=self.device,
        )  # the params are shared by every variant; same relief-aware ground
        return traj.pos.cpu().numpy(), quat.wxyz_to_xyzw(traj.rot).cpu().numpy()
