"""Frozen copy of pegasus_tpu_torch/physics/rigid_body.py at commit 7a69f88, without the captured CUDA-graph step: every drop runs op by op; cut to what the benchmark calls.

Batched rigid-body dynamics on torch tensors.

Port of ``pegasus_tpu/physics/rigid_body.py``: drop rigid objects onto a
ground-aligned environment and record per-step poses.  The model is the
reference's, pass for pass:

* bodies: environment (body 0, static, infinite mass) + K dynamic objects,
  matching Bullet body ids in the trajectory JSON;
* collision geometry: per-body point cloud against the environment's
  heightfield, plus point-vs-hull and edge-vs-edge contacts between objects;
* contacts: impulse-based with Baumgarte positional bias, Coulomb friction,
  Jacobi splits inside Gauss-Seidel sweeps over the three passes;
* integrator: semi-implicit Euler, q' = q + dt/2 * omega (x) q, dt = 1 ms
  and gravity (0, 0, -50) by default.

Where the reference gets its scene batch from ``vmap``, every function here
carries ONE leading scene axis: state tensors are ``[S, B, ...]``, params
are ``[S, B, ...]`` (one set per scene) or ``[1, B, ...]`` (shared), and
``simulate`` is ``simulate_batch`` at S = 1 with the axis stripped.  All
shapes are static, every mask stays a mask (``torch.where``), nothing reads
a tensor on the host, and every contraction over a 3-vector is an explicit
elementwise product and sum, so a step computes the same float32 values
whether its kernels are launched one by one or replayed.

On a CUDA device ``simulate`` / ``simulate_batch`` capture one ``step`` into
a ``torch.cuda.CUDAGraph`` and replay it ``n_steps`` times (the counterpart
of the reference's ``jit`` + ``scan``); the captured program is cached per
shapes and constants.  On the CPU the same ``step`` runs op by op.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from reference.frozen.device import DEFAULT_DEVICE, resolve_device
from reference.frozen.physics.heightfield import Heightfield, height_at, normal_at
from reference.frozen.utils import quaternion as quat

DEFAULT_GRAVITY = (0.0, 0.0, -50.0)
DEFAULT_DT = 1.0 / 1000.0


@dataclass(frozen=True)
class RigidBodyState:
    pos: torch.Tensor  # [..., B, 3] world position of body origin
    rot: torch.Tensor  # [..., B, 4] wxyz orientation
    linvel: torch.Tensor  # [..., B, 3]
    angvel: torch.Tensor  # [..., B, 3] world frame


    def replace(self, **changes) -> "RigidBodyState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "RigidBodyState":
        return _map_tensors(self, lambda t: t.to(device))

    def packed(self) -> torch.Tensor:
        """[..., B, 13]: pos, rot, linvel, angvel side by side."""
        return torch.cat([self.pos, self.rot, self.linvel, self.angvel], dim=-1)

    @classmethod
    def unpacked(cls, rows: torch.Tensor) -> "RigidBodyState":
        return cls(pos=rows[..., 0:3], rot=rows[..., 3:7],
                   linvel=rows[..., 7:10], angvel=rows[..., 10:13])


@dataclass(frozen=True)
class RigidBodyParams:
    inv_mass: torch.Tensor  # [..., B] 0 for static bodies (environment)
    inv_inertia: torch.Tensor  # [..., B, 3] inverse principal inertia (body frame)
    points: torch.Tensor  # [..., B, P, 3] collision points in body frame
    point_mask: torch.Tensor  # [..., B, P] bool
    radius: torch.Tensor  # [..., B] bounding-sphere radius (pair broad phase)
    friction: torch.Tensor  # [..., B]
    restitution: torch.Tensor  # [..., B]
    body_mask: torch.Tensor  # [..., B] bool: body exists (padding support)
    half_extents: Optional[torch.Tensor] = None  # [..., B, 3] box fallback for hull planes
    plane_n: Optional[torch.Tensor] = None  # [..., B, H, 3] convex-hull facet normals (body)
    plane_d: Optional[torch.Tensor] = None  # [..., B, H] facet offsets: inside iff n.x <= d
    plane_group: Optional[torch.Tensor] = None  # [..., B, H] hull part id (multi-hull
    # approximate convex decomposition; padding planes carry d=1e9)
    edge_a: Optional[torch.Tensor] = None  # [..., B, E, 3] hull edge start points (body frame)
    edge_b: Optional[torch.Tensor] = None  # [..., B, E, 3] hull edge end points
    edge_mask: Optional[torch.Tensor] = None  # [..., B, E] bool
    num_hull_parts: int = 1  # static: the group loop's trip count

    def __post_init__(self):
        put = lambda name, value: object.__setattr__(self, name, value)
        dev = self.radius.device
        if self.half_extents is None:
            # fall back to a cube from the bounding sphere
            put("half_extents",
                (self.radius / math.sqrt(3.0))[..., None].expand(*self.radius.shape, 3))
        if self.plane_n is None:
            # box half-space set from half_extents (6 axis-aligned facets):
            # the pair narrow phase is point-vs-convex-hull, a box is the
            # 6-plane special case
            he = self.half_extents.to(torch.float32)
            eye = torch.eye(3, dtype=torch.float32, device=dev)
            n = torch.cat([eye, -eye], dim=0)  # [6, 3]
            put("plane_n", n.expand(*he.shape[:-1], 6, 3))
            put("plane_d", torch.cat([he, he], dim=-1))  # [..., B, 6]
        if self.plane_group is None:
            put("plane_group", torch.zeros(self.plane_d.shape, dtype=torch.int32, device=dev))
        if self.edge_a is None:
            # the 12 box edges from half_extents (the engine passes real
            # hull edges for mesh bodies; this is the box fallback)
            he = self.half_extents.to(torch.float32)
            corners = torch.tensor(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                dtype=torch.float32, device=dev,
            )  # [8, 3] sign patterns
            # 12 edges as (corner, corner) differing in one axis
            pairs = [(a, c) for a in range(8) for c in range(a + 1, 8)
                     if bin(a ^ c).count("1") == 1]
            ca = corners[[a for a, _ in pairs]]  # [12, 3]
            cb = corners[[c for _, c in pairs]]
            put("edge_a", he[..., None, :] * ca)
            put("edge_b", he[..., None, :] * cb)
        if self.edge_mask is None:
            put("edge_mask", self.body_mask[..., None].expand(self.edge_a.shape[:-1]))

    def replace(self, **changes) -> "RigidBodyParams":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "RigidBodyParams":
        return _map_tensors(self, lambda t: t.to(device))


def _map_tensors(obj, fn):
    """A copy of a dataclass with ``fn`` applied to every tensor field."""
    return type(obj)(**{
        f.name: fn(v) if isinstance(v, torch.Tensor) else v
        for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)
    })


def _with_scene_axis(obj):
    """``obj`` (params or state) with a leading scene axis of size 1 on every
    tensor, when its per-body tensors do not carry one yet."""
    per_body = obj.inv_mass if isinstance(obj, RigidBodyParams) else obj.pos[..., 0]
    return obj if per_body.dim() > 1 else _map_tensors(obj, lambda t: t[None])


def _matvec(M, v):
    """M [..., 3, 3] applied to v [..., 3] (leading axes broadcast)."""
    return (M * v[..., None, :]).sum(-1)


def _matTvec(M, v):
    """M^T v: sum_a M[..., a, b] v[..., a]."""
    return (M * v[..., :, None]).sum(-2)


def _facet_dots(plane_n, p):
    """n_h . p for facets plane_n [..., H, 3] and points p [..., 3]: the
    result has the facet axis last.  Three broadcast products, so nothing
    of shape [..., H, 3] is ever held."""
    return (
        p[..., None, 0] * plane_n[..., 0]
        + p[..., None, 1] * plane_n[..., 1]
        + p[..., None, 2] * plane_n[..., 2]
    )


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _inv_inertia_world(R, inv_inertia):
    """R diag(I^-1) R^T, [S, B, 3, 3]."""
    return (R[..., :, None, :] * inv_inertia[..., None, None, :] * R[..., None, :, :]).sum(-1)


def _world_points(state: RigidBodyState, params: RigidBodyParams):
    """[S, B, P, 3] collision points in world frame and their lever arms."""
    R = quat.quat_to_rotmat(state.rot)  # [S, B, 3, 3]
    arms = _matvec(R[:, :, None], params.points)  # r_i in world
    return state.pos[:, :, None, :] + arms, arms


def _ground_manifold(
    state: RigidBodyState,
    params: RigidBodyParams,
    hf: Heightfield,
    dt: float,
    baumgarte: float,
    slop: float,
):
    """The part of the ground pass that depends on POSITIONS only: which
    points touch the heightfield, their normals, arms, normal effective
    masses and Baumgarte bias.  ``_step`` builds it once per timestep and the
    solver sweeps reuse it (under ``jit`` the reference's compiler hoists the
    same work out of its iteration loop).

    Returns (active [S,B,P] bool, n_active [S,B,1], n [S,B,P,3],
    r [S,B,P,3], m_eff [S,B,P], bias [S,B,P], inv_I_world [S,B,3,3]).
    """
    x, r = _world_points(state, params)  # [S, B, P, 3]
    ground = height_at(hf, x[..., 0], x[..., 1])
    pen = ground - x[..., 2]  # penetration depth (>0 below the surface)
    active = (pen > 0.0) & params.point_mask & (params.inv_mass > 0)[..., None]
    n_active = torch.clamp(active.sum(dim=2, keepdim=True), min=1)

    R = quat.quat_to_rotmat(state.rot)
    inv_I_world = _inv_inertia_world(R, params.inv_inertia)

    n = normal_at(hf, x[..., 0], x[..., 1])  # [S, B, P, 3]

    # effective mass along the normal at each point
    rxn = _cross(r, n)  # [S, B, P, 3]
    ang_term = (rxn * _matvec(inv_I_world[:, :, None], rxn)).sum(-1)
    m_eff_inv = params.inv_mass[..., None] + ang_term
    m_eff = 1.0 / torch.clamp(m_eff_inv, min=1e-9)
    bias = (baumgarte / dt) * torch.clamp(pen - slop, min=0.0)
    return active, n_active, n, r, m_eff, bias, inv_I_world


def _ground_impulses(state: RigidBodyState, params: RigidBodyParams, manifold):
    """Velocity solve of the ground pass on a precomputed manifold (one
    Jacobi sweep).  Returns (dv, dw) world-frame velocity corrections per
    body, [S, B, 3] each."""
    active, n_active, n, r, m_eff, bias, inv_I_world = manifold
    inv_I_p = inv_I_world[:, :, None]  # against the point axis

    # velocity of each contact point
    u = state.linvel[:, :, None, :] + _cross(state.angvel[:, :, None, :], r)
    u_n = (u * n).sum(-1)

    # normal impulse toward a TARGET separation velocity: the larger of
    # the Baumgarte bias and the restitution bounce.  Driving u_n *to*
    # the target (rather than adding the bias unconditionally) stops the
    # solver iterations from pumping velocity into resting contacts.
    e = params.restitution[..., None]
    target = torch.maximum(-e * torch.clamp(u_n, max=0.0), bias)
    zero = torch.zeros_like(u_n)
    jn = torch.where(active, m_eff * torch.clamp(target - u_n, min=0.0), zero)

    # friction impulse: oppose tangential velocity, clamped by mu * jn
    u_t = u - u_n[..., None] * n
    u_t_norm = torch.linalg.vector_norm(u_t, dim=-1)
    t_hat = u_t / torch.clamp(u_t_norm, min=1e-9)[..., None]
    rxt = _cross(r, t_hat)
    ang_term_t = (rxt * _matvec(inv_I_p, rxt)).sum(-1)
    m_eff_t = 1.0 / torch.clamp(params.inv_mass[..., None] + ang_term_t, min=1e-9)
    jt = torch.minimum(m_eff_t * u_t_norm, params.friction[..., None] * jn)
    jt = torch.where(active, jt, zero)

    # total impulse per point, split across simultaneous contacts (Jacobi)
    imp = (jn[..., None] * n - jt[..., None] * t_hat) / n_active[..., None]
    imp = torch.where(active[..., None], imp, torch.zeros_like(imp))

    dv = params.inv_mass[..., None] * imp.sum(dim=2)
    dw = _matvec(inv_I_world, _cross(r, imp).sum(dim=2))
    return dv, dw


def _hull_union_reduce(facet_pen, group, real, n_groups: int):
    """Decomposed-hull membership reduce shared by the point and edge
    narrow phases: per hull part, the min facet distance (signed; > 0
    means inside that part's margin shell); the DEEPEST part wins.
    ``group`` / ``real`` broadcast against facet_pen's last (facet) axis.
    Returns (depth [...], h_star [...]): h_star is the binding facet index
    within the winning part (meaningful only where depth > 0).  Ties take
    the first facet, as the reference's argmin does."""
    depth = torch.full(facet_pen.shape[:-1], -math.inf, dtype=facet_pen.dtype,
                       device=facet_pen.device)
    h_star = torch.zeros(facet_pen.shape[:-1], dtype=torch.int64, device=facet_pen.device)
    inf = torch.full_like(facet_pen[..., :1], math.inf)
    for g in range(n_groups):
        in_g = group == g
        depth_g, h_g = torch.where(in_g, facet_pen, inf).min(dim=-1)
        exists_g = (in_g & real).any(dim=-1)
        valid_g = torch.isfinite(depth_g) & exists_g
        better = valid_g & (depth_g > depth)
        depth = torch.where(better, depth_g, depth)
        h_star = torch.where(better, h_g, h_star)
    return depth, h_star


def _facet_normal_of(plane_n, h_star):
    """plane_n[s, j, h_star[s, i, j, k]] -> [S, B_i, B_j, K, 3]: body j's
    facet normal picked per contact, by indexing (the broadcast
    [S, B, B, K, H, 3] of the reference's take_along_axis is never built)."""
    dev = plane_n.device
    s_idx = torch.arange(plane_n.shape[0], device=dev).view(-1, 1, 1, 1)
    j_idx = torch.arange(plane_n.shape[1], device=dev).view(1, 1, -1, 1)
    return plane_n[s_idx, j_idx, h_star]


def _pair_manifold(
    state: RigidBodyState,
    params: RigidBodyParams,
    dt: float,
    baumgarte: float,
    margin: float = 4e-3,
):
    """The part of the point-vs-hull pass that depends on POSITIONS only:
    body i's collision points against body j's convex hull (half-space
    set), built once per timestep like the edge manifold.

    Point-vs-hull narrow phase (bounding spheres gate the pairs): each of
    i's contact points is tested against j's hull planes; penetration is
    the minimum facet distance and the contact normal is that facet's
    world normal.  j's collision shape is a UNION of convex parts
    (plane_group ids): a point collides a part iff n_h . p <= d_h + margin
    for ALL of that part's facets; among penetrated parts the deepest one
    supplies depth and normal.

    Returns (inside [S,B,B,P] bool, n_pair [S,B,B,1], n [S,B,B,P,3],
    r_i [S,B,1,P,3], r_j [S,B,B,P,3], m_eff [S,B,B,P], bias [S,B,B,P],
    mu [S,B,B,1], inv_I_world [S,B,3,3], h_star [S,B,B,P], depth [S,B,B,P]).
    """
    b = state.pos.shape[1]
    dev = state.pos.device
    x, r_arm = _world_points(state, params)  # [S, B, P, 3] of OWNER i
    R = quat.quat_to_rotmat(state.rot)  # [S, B, 3, 3]
    inv_I_world = _inv_inertia_world(R, params.inv_inertia)
    eye = torch.eye(b, dtype=torch.float32, device=dev)

    # broad phase
    diff = state.pos[:, :, None, :] - state.pos[:, None, :, :]
    dist = torch.linalg.vector_norm(diff + eye[..., None], dim=-1)
    rsum = params.radius[:, :, None] + params.radius[:, None, :]
    dynamic = (params.inv_mass > 0) & params.body_mask
    pair_ok = (
        dynamic[:, :, None] & dynamic[:, None, :] & ~eye.bool()
        & (dist < rsum)
    )  # [S, B(i), B(j)]

    # i's points in j's local frame: [S, B_i, B_j, P, 3]
    rel = x[:, :, None, :, :] - state.pos[:, None, :, None, :]
    R_j = R[:, None, :, None]  # [S, 1, B_j, 1, 3, 3]
    p_local = _matTvec(R_j, rel)  # R_j^T @ rel
    # signed distance to each hull facet of j, with a margin shell so that
    # exactly-touching faces resolve
    facet_pen = (
        (params.plane_d + margin)[:, None, :, None, :]
        - _facet_dots(params.plane_n[:, None, :, None], p_local)
    )  # [S, B_i, B_j, P, H]
    depth, h_star = _hull_union_reduce(
        facet_pen,
        params.plane_group[:, None, :, None, :],
        (params.plane_d < 1e8)[:, None, :, None, :],
        params.num_hull_parts,
    )

    inside = (depth > 0.0) & pair_ok[:, :, :, None]
    inside = inside & params.point_mask[:, :, None, :]
    depth = torch.where(inside, depth, torch.zeros_like(depth))
    n_local = _facet_normal_of(params.plane_n, h_star)  # outward facet normal, j's frame
    # world normal points from j toward i (outward from j's hull part)
    n = _matvec(R_j, n_local)

    r_i = r_arm[:, :, None, :, :]  # arm on i
    r_j = rel  # arm on j

    # effective mass with angular terms on both bodies
    rxn_i = _cross(r_i, n)
    rxn_j = _cross(r_j, n)
    ang_i = (rxn_i * _matvec(inv_I_world[:, :, None, None], rxn_i)).sum(-1)
    ang_j = (rxn_j * _matvec(inv_I_world[:, None, :, None], rxn_j)).sum(-1)
    m_eff = 1.0 / torch.clamp(
        params.inv_mass[:, :, None, None] + params.inv_mass[:, None, :, None]
        + ang_i + ang_j,
        min=1e-9,
    )

    # positional bias only for penetration beyond the margin shell; capped
    # so deeply-overlapping spawns separate gently instead of being
    # launched.  The bias is a TARGET separation velocity (see
    # _ground_impulses).
    bias = torch.clamp((baumgarte / dt) * torch.clamp(depth - margin, min=0.0), max=1.0)
    n_pair = torch.clamp(inside.sum(dim=3, keepdim=True), min=1)
    mu = torch.minimum(params.friction[:, :, None], params.friction[:, None, :])[..., None]
    return inside, n_pair, n, r_i, r_j, m_eff, bias, mu, inv_I_world, h_star, depth


def _pair_impulses(state: RigidBodyState, params: RigidBodyParams, manifold):
    """Velocity solve of the point-vs-hull pass on a precomputed manifold:
    impulses (normal + Baumgarte bias, Coulomb friction) apply
    equal-and-opposite to both bodies with full angular terms.
    Returns (dv [S, B, 3], dw [S, B, 3])."""
    inside, n_pair, n, r_i, r_j, m_eff, bias, mu, inv_I_world = manifold[:9]

    # contact-point velocities
    u = (
        state.linvel[:, :, None, None, :]
        + _cross(state.angvel[:, :, None, None, :], r_i)
        - state.linvel[:, None, :, None, :]
        - _cross(state.angvel[:, None, :, None, :], r_j)
    )
    u_n = (u * n).sum(-1)  # [S, B_i, B_j, P]

    jn = m_eff * torch.clamp(bias - u_n, min=0.0)
    # Jacobi split PER PAIR with over-relaxation: contacts of one pair
    # share (roughly) a direction, so dividing by the pair's count and
    # relaxing toward full correction converges in few sweeps without the
    # dilution a global per-body split causes
    zero = torch.zeros_like(jn)
    jn = 1.6 * torch.where(inside, jn, zero) / n_pair

    # Coulomb friction against the tangential slip at each contact
    u_t = u - u_n[..., None] * n
    u_t_norm = torch.linalg.vector_norm(u_t, dim=-1)
    t_hat = u_t / torch.clamp(u_t_norm, min=1e-9)[..., None]
    jt = torch.minimum(m_eff * u_t_norm / torch.clamp(n_pair, min=1), mu * jn)
    jt = torch.where(inside, jt, zero)

    imp = jn[..., None] * n - jt[..., None] * t_hat  # on body i (+), j (-)
    dv = params.inv_mass[..., None] * imp.sum(dim=(2, 3)) - (
        params.inv_mass[..., None] * imp.sum(dim=(1, 3))
    )
    torque_i = _cross(r_i, imp).sum(dim=(2, 3))
    # reaction torque on body j accumulates over the other index
    torque_j = -_cross(r_j, imp).sum(dim=(1, 3))
    dw = _matvec(inv_I_world, torque_i + torque_j)
    return dv, dw


def _edge_manifold(
    state: RigidBodyState,
    params: RigidBodyParams,
    margin: float = 4e-3,
    shell: float = 4e-2,
):
    """Edge-edge narrow phase: the contact case point-vs-hull misses.

    Two hulls can interpenetrate with NO vertex of either inside the
    other (two thin boxes crossing like an X).  For every dynamic pair
    (i < j) and every hull-edge pair: closest points between the two
    segments (branchless Ericson clamp), contact normal = the SAT cross
    axis cross(d_i, d_j), and signed penetration = -(c_i - c_j).n.  Only
    INTERIOR solutions count (endpoint-clamped ones are vertex-region
    contacts, which the point pass owns); for interior solutions |pen| IS
    the segment distance and the |pen| < shell window bounds both approach
    distance and accepted penetration.  The top-4 candidates per pair are
    then validated against BOTH hull unions (midpoint inside each within
    the margin), and the normal's final sign comes from j's binding hull
    facet.  Near-parallel edge pairs (face-face contact) are masked out.

    Everything here is a function of POSITIONS only, so ``step`` builds
    the manifold ONCE per timestep and the solver iterations reuse it.

    Returns (active [S,B,B,K] bool, pen [S,B,B,K], n [S,B,B,K,3],
    r_i / r_j [S,B,B,K,3] contact arms, m_eff [S,B,B,K],
    inv_I_world [S,B,3,3]).
    """
    s_n, b = state.pos.shape[:2]
    dev = state.pos.device
    R = quat.quat_to_rotmat(state.rot)  # [S, B, 3, 3]
    inv_I_world = _inv_inertia_world(R, params.inv_inertia)
    a_w = state.pos[:, :, None, :] + _matvec(R[:, :, None], params.edge_a)
    b_w = state.pos[:, :, None, :] + _matvec(R[:, :, None], params.edge_b)
    eye = torch.eye(b, dtype=torch.float32, device=dev)

    # broad phase, ordered pairs only (i < j): each unordered pair is
    # computed once and applied +/- to both bodies
    diff = state.pos[:, :, None, :] - state.pos[:, None, :, :]
    dist_c = torch.linalg.vector_norm(diff + eye[..., None], dim=-1)
    rsum = params.radius[:, :, None] + params.radius[:, None, :]
    dynamic = (params.inv_mass > 0) & params.body_mask
    upper = torch.ones((b, b), dtype=torch.bool, device=dev).triu(1)
    pair_ok = dynamic[:, :, None] & dynamic[:, None, :] & upper & (dist_c < rsum)

    # segment-segment closest points, [S, B_i, B_j, E_i, E_j]
    a1 = a_w[:, :, None, :, None, :]
    d1 = (b_w - a_w)[:, :, None, :, None, :]
    a2 = a_w[:, None, :, None, :, :]
    d2 = (b_w - a_w)[:, None, :, None, :, :]
    r0 = a1 - a2
    A = (d1 * d1).sum(-1)
    E2 = (d2 * d2).sum(-1)
    C = (d1 * r0).sum(-1)
    F = (d2 * r0).sum(-1)
    Bd = (d1 * d2).sum(-1)
    den = A * E2 - Bd * Bd
    den_ok = den > 1e-12
    s = torch.clamp(
        torch.where(den_ok, (Bd * F - C * E2) / torch.where(den_ok, den, torch.ones_like(den)),
                    torch.zeros_like(den)),
        0.0, 1.0,
    )
    t = torch.clamp((Bd * s + F) / torch.clamp(E2, min=1e-12), 0.0, 1.0)
    s = torch.clamp((Bd * t - C) / torch.clamp(A, min=1e-12), 0.0, 1.0)
    c1 = a1 + s[..., None] * d1
    c2 = a2 + t[..., None] * d2

    # SAT cross axis; provisionally oriented from j toward i by body
    # centers: the FINAL orientation comes from j's binding hull facet
    # after selection
    n = _cross(d1.expand(c1.shape), d2.expand(c2.shape))
    n_norm = torch.linalg.vector_norm(n, dim=-1)
    sin_angle = n_norm / torch.clamp(torch.sqrt(A * E2), min=1e-12)
    n = n / torch.clamp(n_norm, min=1e-9)[..., None]
    sign = torch.sign((n * diff[:, :, :, None, None, :]).sum(-1))
    n = n * torch.where(sign == 0.0, torch.ones_like(sign), sign)[..., None]
    pen = -((c1 - c2) * n).sum(-1)

    # endpoint-clamped solutions are VERTEX-region contacts (corner on
    # edge): their cross-axis normal is arbitrary and the point pass owns
    # them.  The |pen| window is symmetric because the provisional sign
    # may be flipped.
    interior = (s > 0.02) & (s < 0.98) & (t > 0.02) & (t < 0.98)
    active = (
        pair_ok[:, :, :, None, None]
        & params.edge_mask[:, :, None, :, None]
        & params.edge_mask[:, None, :, None, :]
        & (sin_angle > 0.05)
        & interior
        & (pen.abs() < shell)
    )

    # manifold cap: keep only the 4 deepest candidates per pair, by four
    # max + argmax passes (ties take the first index), then validate each
    # contact midpoint against BOTH bodies' hull unions: this rejects
    # phantom contacts across concavity openings
    K = 4
    e1, e2 = pen.shape[3], pen.shape[4]
    NEG = -1e30
    score = torch.where(active, pen, torch.full_like(pen, NEG)).reshape(s_n, b, b, e1 * e2)
    tops, idxs = [], []
    for _ in range(K):
        vx, ix = score.max(dim=-1)  # [S, B, B]
        tops.append(vx)
        idxs.append(ix)
        score = score.scatter(-1, ix[..., None], NEG)
    top_pen = torch.stack(tops, dim=-1)  # [S, B, B, K]
    top_idx = torch.stack(idxs, dim=-1)

    def pick(v):  # [S,B,B,E,E,3] -> [S,B,B,K,3]
        flat = v.reshape(s_n, b, b, e1 * e2, 3)
        return torch.gather(flat, 3, top_idx[..., None].expand(*top_idx.shape, 3))

    c1k, c2k, nk = pick(c1), pick(c2), pick(n)
    pen_k = top_pen
    active_k = top_pen > NEG / 2

    m = 0.5 * (c1k + c2k)  # [S, B, B, K, 3]

    # hull-union membership of the midpoint, in both bodies' frames
    # (shared reduce with the point pass)
    def union_depth(p_world, frame):  # frame 'i' or 'j'
        if frame == "j":
            own = lambda v: v[:, None, :, None]
        else:
            own = lambda v: v[:, :, None, None]
        p_loc = _matTvec(own(R), p_world - own(state.pos))
        facet = own(params.plane_d + margin) - _facet_dots(own(params.plane_n), p_loc)
        return _hull_union_reduce(
            facet, own(params.plane_group), own(params.plane_d < 1e8), params.num_hull_parts
        )

    depth_j, hstar_j = union_depth(m, "j")
    depth_i, _ = union_depth(m, "i")
    active_k = active_k & (depth_j > 0.0) & (depth_i > 0.0)

    # FINAL normal orientation from j's binding facet: the facet whose
    # plane the midpoint is deepest behind points OUT of j at the contact,
    # so the contact normal (from j toward i) must have a positive
    # component along it.
    facet_n_local = _facet_normal_of(params.plane_n, hstar_j)  # [S, B, B, K, 3], j's frame
    facet_n_world = _matvec(R[:, None, :, None], facet_n_local)
    dotf = (nk * facet_n_world).sum(-1)
    flip = torch.where(dotf.abs() > 1e-6, torch.sign(dotf), torch.ones_like(dotf))
    nk = nk * flip[..., None]
    pen_k = pen_k * flip
    active_k = active_k & (pen_k > -margin)

    r_i = m - state.pos[:, :, None, None, :]
    r_j = m - state.pos[:, None, :, None, :]
    rxn_i = _cross(r_i, nk)
    rxn_j = _cross(r_j, nk)
    ang_i = (rxn_i * _matvec(inv_I_world[:, :, None, None], rxn_i)).sum(-1)
    ang_j = (rxn_j * _matvec(inv_I_world[:, None, :, None], rxn_j)).sum(-1)
    m_eff = 1.0 / torch.clamp(
        params.inv_mass[:, :, None, None]
        + params.inv_mass[:, None, :, None]
        + ang_i + ang_j,
        min=1e-9,
    )
    pen_k = torch.where(active_k, pen_k, torch.zeros_like(pen_k))
    return active_k, pen_k, nk, r_i, r_j, m_eff, inv_I_world


def _edge_impulses(
    state: RigidBodyState,
    params: RigidBodyParams,
    manifold,
    dt: float,
    baumgarte: float,
):
    """Velocity solve on a precomputed edge manifold (_edge_manifold).
    Only this part runs inside the solver iterations."""
    active_k, pen_k, nk, r_i, r_j, m_eff, inv_I_world = manifold
    u = (
        state.linvel[:, :, None, None, :]
        + _cross(state.angvel[:, :, None, None, :], r_i)
        - state.linvel[:, None, :, None, :]
        - _cross(state.angvel[:, None, :, None, :], r_j)
    )
    u_n = (u * nk).sum(-1)
    # the Baumgarte bias is a TARGET separation velocity, not an additive
    # term: drive u_n up to `bias` and no further, else the solver
    # iterations pump velocity into resting contacts and launch bodies
    bias = torch.clamp((baumgarte / dt) * torch.clamp(pen_k, min=0.0), max=1.0)
    jn = m_eff * torch.clamp(bias - u_n, min=0.0)
    n_pair = torch.clamp(active_k.sum(dim=3, keepdim=True), min=1)
    zero = torch.zeros_like(jn)
    jn = torch.where(active_k, jn, zero) / n_pair

    u_t = u - u_n[..., None] * nk
    u_t_norm = torch.linalg.vector_norm(u_t, dim=-1)
    t_hat = u_t / torch.clamp(u_t_norm, min=1e-9)[..., None]
    mu = torch.minimum(params.friction[:, :, None], params.friction[:, None, :])[..., None]
    jt = torch.minimum(m_eff * u_t_norm / n_pair, mu * jn)
    jt = torch.where(active_k, jt, zero)

    imp = jn[..., None] * nk - jt[..., None] * t_hat  # on i (+), on j (-)
    sum_as_i = imp.sum(dim=(2, 3))  # [S, B, 3]
    sum_as_j = imp.sum(dim=(1, 3))
    dv = params.inv_mass[..., None] * (sum_as_i - sum_as_j)
    torque_i = _cross(r_i, imp).sum(dim=(2, 3))
    torque_j = -_cross(r_j, imp).sum(dim=(1, 3))
    dw = _matvec(inv_I_world, torque_i + torque_j)
    return dv, dw


def _step(params, state, hf, g, dt: float, iters: int, baumgarte: float, slop: float):
    """One timestep on tensors that all carry the scene axis; ``g`` is the
    gravity vector as a tensor on the state's device."""
    dyn = ((params.inv_mass > 0) & params.body_mask).to(torch.float32)[..., None]
    st = state.replace(linvel=state.linvel + dyn * g * dt)

    # positions are fixed during the velocity iterations, so everything the
    # three passes derive from positions alone (the ground and point-vs-hull
    # manifolds, and the expensive E x E edge sweep) is built ONCE here
    ground_man = _ground_manifold(st, params, hf, dt, baumgarte, slop)
    pair_man = _pair_manifold(st, params, dt, baumgarte)
    edge_man = _edge_manifold(st, params)

    for _ in range(iters):
        # Gauss-Seidel over the three passes: each sees the previous
        # pass's velocity update, so a contact already resolved by the
        # point pass leaves no approach velocity for the edge pass to
        # stop again (simultaneous application double-counts the stopping
        # impulse and LAUNCHES stacked drops).
        dv_p, dw_p = _ground_impulses(st, params, ground_man)
        st = st.replace(linvel=st.linvel + dv_p, angvel=st.angvel + dw_p)
        dv_s, dw_s = _pair_impulses(st, params, pair_man)
        st = st.replace(linvel=st.linvel + dv_s, angvel=st.angvel + dw_s)
        dv_e, dw_e = _edge_impulses(st, params, edge_man, dt, baumgarte)
        st = st.replace(linvel=st.linvel + dv_e, angvel=st.angvel + dw_e)

    # integrate
    new_pos = st.pos + st.linvel * dt
    w_quat = torch.cat([torch.zeros_like(st.angvel[..., :1]), st.angvel], dim=-1)
    dq = 0.5 * quat.quat_mul(w_quat, st.rot)
    new_rot = quat.normalize(st.rot + dt * dq)
    # mild angular damping stabilizes resting contact (Bullet applies
    # similar default damping)
    return st.replace(
        pos=new_pos,
        rot=new_rot,
        linvel=st.linvel * (1.0 - 0.002),
        angvel=st.angvel * (1.0 - 0.01),
    )


def _gravity_tensor(gravity, device) -> torch.Tensor:
    return torch.tensor(np.asarray(gravity, np.float32), device=device)


def step(
    params: RigidBodyParams,
    state: RigidBodyState,
    dt: float = DEFAULT_DT,
    gravity=DEFAULT_GRAVITY,
    iters: int = 10,
    baumgarte: float = 0.2,
    slop: float = 1e-4,
    heightfield: Optional[Heightfield] = None,
) -> RigidBodyState:
    """One timestep, op by op, on the device the state lies on.  ``state``
    is ``[B, ...]`` (one scene; params ``[B, ...]``) or ``[S, B, ...]``
    (params ``[B, ...]`` shared or ``[S, B, ...]``)."""
    dev = state.pos.device
    single = state.pos.dim() == 2
    hf = heightfield if heightfield is not None else Heightfield.flat(device=dev)
    out = _step(_with_scene_axis(params), _with_scene_axis(state), hf,
                _gravity_tensor(gravity, dev), dt, iters, baumgarte, slop)
    return _map_tensors(out, lambda t: t[0]) if single else out


def _rollout_eager(params, state, hf, n_steps, gravity, dt, iters, baumgarte, slop):
    """[T, S, B, 13] by ``n_steps`` op-by-op steps: what runs on the
    CPU, and what the captured step is held against on the card."""
    g = _gravity_tensor(gravity, state.pos.device)
    rows = []
    for _ in range(n_steps):
        state = _step(params, state, hf, g, dt, iters, baumgarte, slop)
        rows.append(state.packed())
    return torch.stack(rows, dim=0)


def _simulate_batch(params, state0, n_steps, dt, gravity, iters, heightfield,
                    baumgarte, slop, device, replay: bool):
    dev = resolve_device(device)
    params = _with_scene_axis(params.to(dev))
    state0 = state0.to(dev)
    hf = heightfield.to(dev) if heightfield is not None else Heightfield.flat(device=dev)
    with torch.no_grad():
        rows = _rollout_eager(params, state0, hf, n_steps, gravity, dt, iters,
                              baumgarte, slop)
    final = RigidBodyState.unpacked(rows[-1]) if n_steps else state0
    return RigidBodyState.unpacked(rows.transpose(0, 1)), final


def simulate_batch(
    params: RigidBodyParams,
    state0: RigidBodyState,
    n_steps: int = 310,
    dt: float = DEFAULT_DT,
    gravity=DEFAULT_GRAVITY,
    iters: int = 10,
    heightfield: Optional[Heightfield] = None,
    baumgarte: float = 0.2,
    slop: float = 1e-4,
    device=DEFAULT_DEVICE,
) -> Tuple[RigidBodyState, RigidBodyState]:
    """Run S drops as one program, recording every step.

    ``state0`` is ``[S, B, ...]``; ``params`` ``[S, B, ...]`` or ``[B, ...]``
    (shared by every scene).  Returns (trajectory ``[S, T, B, ...]``, final
    state ``[S, B, ...]``) on ``device``.  On a CUDA device the step is a
    captured graph replayed ``n_steps`` times; on the CPU it runs op by op.
    """
    return _simulate_batch(params, state0, n_steps, dt, gravity, iters, heightfield,
                           baumgarte, slop, device,
                           replay=False)


def simulate(
    params: RigidBodyParams,
    state0: RigidBodyState,
    n_steps: int = 310,
    dt: float = DEFAULT_DT,
    gravity=DEFAULT_GRAVITY,
    iters: int = 10,
    heightfield: Optional[Heightfield] = None,
    baumgarte: float = 0.2,
    slop: float = 1e-4,
    device=DEFAULT_DEVICE,
) -> Tuple[RigidBodyState, RigidBodyState]:
    """Run one drop, recording every step: ``simulate_batch`` at S = 1.

    Returns (trajectory states with leading time axis ``[T, B, ...]``, final
    state ``[B, ...]``): every body's (t, q) at every timestep, as the
    reference's recording loop stores them.
    """
    traj, final = simulate_batch(params, _with_scene_axis(state0), n_steps, dt, gravity, iters,
                                 heightfield, baumgarte, slop, device)
    strip = lambda t: t[0]
    return _map_tensors(traj, strip), _map_tensors(final, strip)
