"""Port parity, physics: the torch stepper against the JAX stepper on the CPU.

The same inputs, made with numpy from a seed, go through both packages:
``height_at`` / ``normal_at``; the four contact passes on in-contact states
(three boxes in a pile, a hull decomposed into three parts, two crossed thin
boxes that only touch edge to edge); one ``step`` teacher-forced from states
along a JAX trajectory of a three-object drop, free fall through rest; the
first steps of a roll-out; ``simulate_batch`` row by row against
``simulate``; and the defaults ``RigidBodyParams`` derives.

Tolerances: passes atol 1e-5 + rtol 1e-4 with masks and binding facets
equal; a step's pos and rot 1e-5, its velocities atol 1e-4 + rtol 1e-3 (ten
solver sweeps amplify the rounding of two compilers); a roll-out 1e-5 while
it lasts 60 steps.  The dynamics are chaotic after first contact, so no long
trajectory is compared step for step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.physics import heightfield as jhf
from pegasus_tpu.physics import rigid_body as jrb
from pegasus_tpu.utils import quaternion as jq

from pegasus_tpu_torch.interop import rigid_body_from_numpy
from pegasus_tpu_torch.physics import heightfield as thf
from pegasus_tpu_torch.physics import rigid_body as trb
from pegasus_tpu_torch.utils import quaternion as tq

torch.set_num_threads(1)

STATE_FIELDS = ("pos", "rot", "linvel", "angvel")
PASS_TOL = dict(atol=1e-5, rtol=1e-4)


# -- inputs made with numpy ---------------------------------------------------------


def box_points(he, with_edges=True):
    """Corners, face centres and (optionally) edge midpoints of a box."""
    he = np.asarray(he, np.float64)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    pts = [signs * he, np.diag(he), -np.diag(he)]
    if with_edges:
        for ax in range(3):
            o1, o2 = (ax + 1) % 3, (ax + 2) % 3
            for s1 in (-1, 1):
                for s2 in (-1, 1):
                    p = np.zeros(3)
                    p[o1], p[o2] = s1 * he[o1], s2 * he[o2]
                    pts.append(p[None])
    return np.concatenate(pts, axis=0)


def box_params_np(halfs, masses, points=None, friction=0.5):
    """Body 0 = static plane environment; bodies 1..N = boxes.  Returns the
    required fields plus ``half_extents`` as numpy arrays."""
    n = 1 + len(halfs)
    pts = points if points is not None else [box_points(h) for h in halfs]
    p_max = max(len(p) for p in pts)
    out = dict(
        inv_mass=np.zeros(n, np.float32), inv_inertia=np.zeros((n, 3), np.float32),
        points=np.zeros((n, p_max, 3), np.float32), point_mask=np.zeros((n, p_max), bool),
        radius=np.full(n, 1e-3, np.float32), friction=np.full(n, friction, np.float32),
        restitution=np.zeros(n, np.float32), body_mask=np.ones(n, bool),
        half_extents=np.full((n, 3), 1e-3, np.float32),
    )
    for i, (h, m) in enumerate(zip(halfs, masses), start=1):
        out["points"][i, : len(pts[i - 1])] = pts[i - 1]
        out["point_mask"][i, : len(pts[i - 1])] = True
        out["half_extents"][i] = h
        out["inv_mass"][i] = 1.0 / m
        ext = 2 * np.asarray(h)
        out["inv_inertia"][i] = 1.0 / (m / 12.0 * np.array(
            [ext[1] ** 2 + ext[2] ** 2, ext[0] ** 2 + ext[2] ** 2, ext[0] ** 2 + ext[1] ** 2]))
        out["radius"][i] = float(np.linalg.norm(h))
    return out


def both_params(fields: dict, num_hull_parts: int = 1):
    """(JAX params, torch params) from one dict of numpy arrays: the torch
    side gets exactly the arrays the JAX dataclass ends up holding."""
    jp = jrb.RigidBodyParams(**{k: jnp.asarray(v) for k, v in fields.items()},
                             num_hull_parts=num_hull_parts)
    as_np = {f.name: (getattr(jp, f.name) if f.name == "num_hull_parts"
                      else np.asarray(getattr(jp, f.name)))
             for f in dataclasses.fields(jp)}
    tp, _ = rigid_body_from_numpy(as_np, dict.fromkeys(STATE_FIELDS, np.zeros(1, np.float32)),
                                  device="cpu")
    return jp, tp


def both_states(pos, rot, linvel=None, angvel=None):
    pos = np.asarray(pos, np.float32)
    linvel = np.zeros_like(pos) if linvel is None else np.asarray(linvel, np.float32)
    angvel = np.zeros_like(pos) if angvel is None else np.asarray(angvel, np.float32)
    js = jrb.RigidBodyState.rest(pos, np.asarray(rot, np.float32)).replace(
        linvel=jnp.asarray(linvel), angvel=jnp.asarray(angvel))
    return js, torch_state(js)


def torch_state(js) -> trb.RigidBodyState:
    """The torch state holding a JAX state's exact values."""
    return trb.RigidBodyState(**{f: torch.tensor(np.asarray(getattr(js, f))) for f in STATE_FIELDS})


scene = trb._with_scene_axis  # add the leading scene axis the internal passes carry


def seeded_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# -- heightfield, quaternions, defaults ---------------------------------------------


@pytest.mark.parametrize("resolution", [2, 33])
def test_height_and_normal_match_reference(resolution):
    rng = np.random.default_rng(resolution)
    grid = (0.03 * rng.random((resolution, resolution))).astype(np.float32)
    if resolution == 2:
        grid[:] = 0.0  # Heightfield.flat
    x0, y0, inv = np.float32(-0.7), np.float32(-0.5), np.float32((resolution - 1) / 1.3)
    j = jhf.Heightfield(jnp.asarray(grid), jnp.float32(x0), jnp.float32(y0), jnp.float32(inv),
                        jnp.float32(inv))
    t = thf.Heightfield(torch.tensor(grid), *(torch.tensor(v) for v in (x0, y0, inv, inv)))
    # inside, on the border cells, and outside the grid; over [S, B, P] axes
    xy = rng.uniform(-1.0, 1.0, size=(2, 3, 40, 2)).astype(np.float32)
    xy[0, 0, :4] = [[-0.7, -0.5], [0.6, 0.8], [0.6 - 1e-6, 0.8 - 1e-6], [-0.7 + 1e-7, 0.3]]
    hj = np.asarray(jhf.height_at(j, jnp.asarray(xy[..., 0]), jnp.asarray(xy[..., 1])))
    ht = thf.height_at(t, torch.tensor(xy[..., 0]), torch.tensor(xy[..., 1])).numpy()
    assert (hj != 0).any() or resolution == 2
    assert (hj == 0).any()  # some points lie outside
    np.testing.assert_allclose(ht, hj, atol=1e-6, rtol=0)
    nj = np.asarray(jhf.normal_at(j, jnp.asarray(xy[..., 0]), jnp.asarray(xy[..., 1])))
    nt = thf.normal_at(t, torch.tensor(xy[..., 0]), torch.tensor(xy[..., 1])).numpy()
    np.testing.assert_allclose(nt, nj, atol=1e-6, rtol=0)


def test_flat_heightfield_equals_reference():
    j, t = jhf.Heightfield.flat(), thf.Heightfield.flat(device="cpu")
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy()) and b.dtype == torch.float32


def test_quaternion_helpers_broadcast_over_leading_axes():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5, 4)).astype(np.float32)
    b = rng.normal(size=(3, 5, 4)).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    np.testing.assert_array_equal(tq.wxyz_to_xyzw(ta).numpy(), np.asarray(jq.wxyz_to_xyzw(jnp.asarray(a))))
    np.testing.assert_array_equal(tq.xyzw_to_wxyz(tq.wxyz_to_xyzw(ta)).numpy(), a)
    np.testing.assert_allclose(tq.normalize(ta).numpy(), np.asarray(jq.normalize(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(tq.quat_mul(ta, tb).numpy(),
                               np.asarray(jq.quat_mul(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    R = tq.quat_to_rotmat(ta)
    assert R.shape == (3, 5, 3, 3)
    np.testing.assert_allclose(R.numpy(), np.asarray(jq.quat_to_rotmat(jnp.asarray(a))), atol=1e-6)


def test_param_defaults_equal_reference_exactly():
    fields = box_params_np([(0.05, 0.03, 0.08), (0.02, 0.11, 0.04)], [0.5, 0.2])
    fields.pop("half_extents")  # so that it, too, is derived (from the radius)
    jp = jrb.RigidBodyParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = trb.RigidBodyParams(**{k: torch.tensor(v) for k, v in fields.items()})
    assert tp.num_hull_parts == jp.num_hull_parts == 1
    for f in dataclasses.fields(tp):
        if f.name == "num_hull_parts":
            continue
        a, b = np.asarray(getattr(jp, f.name)), getattr(tp, f.name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    # and with a leading scene axis on every field
    tps = trb.RigidBodyParams(**{k: torch.tensor(v)[None].repeat(2, *([1] * v.ndim))
                                 for k, v in fields.items()})
    for f in dataclasses.fields(tp):
        if f.name != "num_hull_parts":
            assert torch.equal(getattr(tps, f.name)[1], getattr(tp, f.name)), f.name


# -- the passes on in-contact states ----------------------------------------------------


def pile_case():
    """Three boxes in a pile: on the ground, overlapping each other, moving."""
    rng = np.random.default_rng(5)
    halfs = [(0.05, 0.04, 0.03), (0.04, 0.04, 0.04), (0.06, 0.03, 0.02)]
    fields = box_params_np(halfs, [0.5, 0.3, 0.2])
    pos = np.array([[0, 0, 0], [0.0, 0.0, 0.028], [0.03, 0.02, 0.09], [-0.02, 0.05, 0.055]])
    rot = np.concatenate([[[1, 0, 0, 0]], seeded_quats(rng, 3) * 0.15 + [1, 0, 0, 0]])
    lin = np.concatenate([np.zeros((1, 3)), rng.normal(size=(3, 3)) * 0.3 - [0, 0, 0.4]])
    ang = np.concatenate([np.zeros((1, 3)), rng.normal(size=(3, 3)) * 2.0])
    return both_params(fields), both_states(pos, rot, lin, ang)


def decomposed_case():
    """A U-shaped channel given as THREE convex parts (base and two walls,
    ``num_hull_parts = 3``, padding facets d = 1e9 in group 0), a small box
    inside it touching base and wall, and a second one across its top."""
    rng = np.random.default_rng(9)
    parts = [((0.0, 0.0, -0.03), (0.08, 0.06, 0.01)),  # base
             ((-0.07, 0.0, 0.0), (0.01, 0.06, 0.04)),  # wall -x
             ((0.07, 0.0, 0.0), (0.01, 0.06, 0.04))]  # wall +x
    halfs = [(0.08, 0.06, 0.04), (0.02, 0.02, 0.02), (0.09, 0.02, 0.01)]
    fields = box_params_np(halfs, [1.0, 0.1, 0.1])
    n, h = 4, 24
    eye = np.eye(3)
    normals = np.concatenate([eye, -eye]).astype(np.float32)
    plane_n = np.tile(np.array([0, 0, 1.0], np.float32), (n, h, 1))
    plane_d = np.full((n, h), 1e9, np.float32)
    group = np.zeros((n, h), np.int32)
    for g, (c, he) in enumerate(parts):
        plane_n[1, 6 * g: 6 * g + 6] = normals
        plane_d[1, 6 * g: 6 * g + 6] = np.concatenate([np.add(he, c), np.subtract(he, c)])
        group[1, 6 * g: 6 * g + 6] = g
    for i in (2, 3):
        plane_n[i, :6] = normals
        plane_d[i, :6] = np.concatenate([halfs[i - 1], halfs[i - 1]])
    fields.update(plane_n=plane_n, plane_d=plane_d, plane_group=group)
    pos = np.array([[0, 0, 0], [0, 0, 0.04], [0.043, 0.01, 0.038], [0.0, -0.01, 0.087]])
    rot = np.concatenate([[[1, 0, 0, 0]], seeded_quats(rng, 3) * 0.05 + [1, 0, 0, 0]])
    lin = np.concatenate([np.zeros((1, 3)), rng.normal(size=(3, 3)) * 0.2 - [0, 0, 0.3]])
    ang = np.concatenate([np.zeros((1, 3)), rng.normal(size=(3, 3))])
    return both_params(fields, num_hull_parts=3), both_states(pos, rot, lin, ang)


def crossed_case():
    """Two long thin boxes crossed like an X, corners as the only collision
    points: they touch edge to edge and no vertex is inside the other."""
    he1, he2 = (0.25, 0.03, 0.03), (0.03, 0.25, 0.03)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)
    fields = box_params_np([he1, he2], [0.5, 0.2], points=[signs * he1, signs * he2], friction=0.6)
    pos = np.array([[0, 0, 0], [0, 0, 0.03], [0.004, -0.003, 0.088]])
    rot = np.array([[1, 0, 0, 0], [1, 0, 0, 0], [0.9997, 0.01, -0.02, 0.005]])
    lin = np.array([[0, 0, 0], [0.01, 0, 0], [0.05, -0.02, -0.6]])
    ang = np.array([[0, 0, 0], [0, 0, 0.1], [0.3, -0.2, 0.1]])
    return both_params(fields), both_states(pos, rot, lin, ang)


CASES = {"pile": pile_case, "decomposed": decomposed_case, "crossed": crossed_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def contact_case(request):
    return request.param, CASES[request.param]()


def _close(got: torch.Tensor, want, where=None, **tol):
    got, want = got[0].numpy(), np.asarray(want)
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, **(tol or PASS_TOL))


def test_ground_contacts_match_reference(contact_case):
    name, ((jp, tp), (js, ts)) = contact_case
    hf_j, hf_t = jhf.Heightfield.flat(), thf.Heightfield.flat(device="cpu")
    dv_j, dw_j = jrb._ground_contacts(js, jp, hf_j, 1e-3, 0.2, 1e-4)
    dv_t, dw_t = trb._ground_contacts(scene(ts), trb._with_scene_axis(tp), hf_t, 1e-3, 0.2, 1e-4)
    if name != "crossed":  # there only the lower box touches the ground, at rest
        assert np.abs(np.asarray(dv_j)).max() > 1e-3
    _close(dv_t, dv_j)
    _close(dw_t, dw_j, atol=1e-4, rtol=1e-4)


def test_pair_contacts_match_reference(contact_case):
    name, ((jp, tp), (js, ts)) = contact_case
    tp1 = trb._with_scene_axis(tp)
    dv_j, dw_j = jrb._pair_contacts(js, jp, 1e-3, 0.2)
    dv_t, dw_t = trb._pair_contacts(scene(ts), tp1, 1e-3, 0.2)
    if name == "crossed":  # no vertex inside the other hull: the point pass sees nothing
        assert np.abs(np.asarray(dv_j)).max() == 0.0 and float(dv_t.abs().max()) == 0.0
    else:
        assert np.abs(np.asarray(dv_j)).max() > 1e-3
    _close(dv_t, dv_j)
    _close(dw_t, dw_j, atol=1e-4, rtol=1e-4)
    # the contact set and the binding facets themselves
    inside, _, _, _, _, _, _, _, _, h_star, depth = trb._pair_manifold(scene(ts), tp1, 1e-3, 0.2)
    j_inside, j_hstar, j_depth = _reference_pair_membership(js, jp)
    assert np.array_equal(inside[0].numpy(), j_inside)
    assert np.array_equal(h_star[0].numpy()[j_inside], j_hstar[j_inside])
    np.testing.assert_allclose(depth[0].numpy(), j_depth, **PASS_TOL)


def _reference_pair_membership(js, jp, margin=4e-3):
    """The reference's point-vs-hull membership (rigid_body.py:276-314),
    which ``_pair_contacts`` does not return: inside, h_star, depth."""
    b = js.pos.shape[0]
    x, _ = jrb._world_points(js, jp)
    R = jq.quat_to_rotmat(js.rot)
    diff = js.pos[:, None, :] - js.pos[None, :, :]
    dist = jnp.linalg.norm(diff + jnp.eye(b)[..., None], axis=-1)
    rsum = jp.radius[:, None] + jp.radius[None, :]
    dynamic = (jp.inv_mass > 0) & jp.body_mask
    pair_ok = dynamic[:, None] & dynamic[None, :] & ~jnp.eye(b, dtype=bool) & (dist < rsum)
    rel = x[:, None, :, :] - js.pos[None, :, None, :]
    p_local = jnp.einsum("jab,ijpa->ijpb", R, rel)
    facet_pen = (jp.plane_d + margin)[None, :, None, :] - jnp.einsum(
        "jha,ijpa->ijph", jp.plane_n, p_local)
    depth, h_star = jrb._hull_union_reduce(
        facet_pen, jp.plane_group[None, :, None, :], (jp.plane_d < 1e8)[None, :, None, :],
        jp.num_hull_parts)
    inside = (depth > 0.0) & pair_ok[:, :, None] & jp.point_mask[:, None, :]
    return np.asarray(inside), np.asarray(h_star), np.asarray(jnp.where(inside, depth, 0.0))


def _sorted_contacts(active, *arrays):
    """Active contacts of each pair in a canonical order (by arm), so that
    two manifolds that picked equal-depth candidates in another order
    compare equal."""
    out = []
    for i, j in zip(*np.nonzero(active.any(-1))):
        keep = np.nonzero(active[i, j])[0]
        order = keep[np.lexsort(np.round(arrays[0][i, j][keep], 4).T)]
        out.append([(i, j)] + [a[i, j][order] for a in arrays])
    return out


def test_edge_manifold_and_impulses_match_reference(contact_case):
    name, ((jp, tp), (js, ts)) = contact_case
    tp1 = trb._with_scene_axis(tp)
    man_j = jrb._edge_manifold(js, jp)
    man_t = trb._edge_manifold(scene(ts), tp1)
    act_j = np.asarray(man_j[0])
    act_t = man_t[0][0].numpy()
    if name == "crossed":
        assert act_j[1, 2].sum() >= 2  # the X rests on edge-edge contacts alone
    assert np.array_equal(act_t.sum(-1), act_j.sum(-1))  # contacts per pair
    # r_i, pen, n, r_j, m_eff of every active contact
    pick = lambda man, unbatch: [unbatch(man[k]) for k in (3, 1, 2, 4, 5)]
    got = _sorted_contacts(act_t, *pick(man_t, lambda v: v[0].numpy()))
    want = _sorted_contacts(act_j, *pick(man_j, np.asarray))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, b, **PASS_TOL)
    np.testing.assert_allclose(man_t[6][0].numpy(), np.asarray(man_j[6]), rtol=1e-4, atol=1e-4)

    dv_j, dw_j = jrb._edge_impulses(js, jp, man_j, 1e-3, 0.2)
    dv_t, dw_t = trb._edge_impulses(scene(ts), tp1, man_t, 1e-3, 0.2)
    if name == "crossed":
        assert np.abs(np.asarray(dv_j)).max() > 1e-2
    _close(dv_t, dv_j)
    _close(dw_t, dw_j, atol=1e-4, rtol=1e-4)


# -- one step, teacher-forced along a reference trajectory --------------------------------


DROP_STEPS = 400
FORCED = (0, 40, 80, 110, 130, 150, 170, 200, 250, 300, 399)


def drop_case():
    """Three boxes dropped above one another with seeded tilts: free fall,
    first ground contact near step 75, a pile, rest."""
    rng = np.random.default_rng(21)
    halfs = [(0.05, 0.04, 0.03), (0.04, 0.04, 0.04), (0.06, 0.03, 0.02)]
    fields = box_params_np(halfs, [0.5, 0.3, 0.2])
    pos = np.array([[0, 0, 0], [0.0, 0.0, 0.15], [0.03, 0.01, 0.30], [-0.02, 0.03, 0.45]])
    rot = np.concatenate([[[1, 0, 0, 0]], seeded_quats(rng, 3) * 0.3 + [1, 0, 0, 0]])
    return both_params(fields), both_states(pos, rot)


@pytest.fixture(scope="module")
def drop():
    (jp, tp), (js, ts) = drop_case()
    traj, _ = jrb.simulate(jp, js, n_steps=DROP_STEPS)
    return jp, tp, js, ts, traj


def _state_at(js, traj, t):
    if t == 0:
        return js
    return jrb.RigidBodyState(**{f: getattr(traj, f)[t - 1] for f in STATE_FIELDS})


def test_drop_trajectory_covers_fall_contact_and_rest(drop):
    _, _, _, _, traj = drop
    speed = np.linalg.norm(np.asarray(traj.linvel)[:, 1:], axis=-1).max(axis=1)
    spin = np.abs(np.asarray(traj.angvel)[:, 1:]).max(axis=(1, 2))
    assert spin[39] == 0.0 and speed[39] > 1.5  # still falling at the second forced state
    assert spin[109] > 0.1  # in contact by the fourth
    assert speed[-1] < 0.15  # at rest at the last


@pytest.mark.parametrize("t", FORCED)
def test_step_teacher_forced(drop, t):
    jp, tp, js, _, traj = drop
    state = _state_at(js, traj, t)
    want = jrb.step(jp, state)
    got = trb.step(tp, torch_state(state))
    for f in ("pos", "rot"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-5, rtol=0)
    for f in ("linvel", "angvel"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-4, rtol=1e-3)


def test_rollout_first_steps(drop):
    jp, tp, _, ts, traj = drop
    got, final = trb.simulate(tp, ts, n_steps=60, device="cpu")
    assert got.pos.shape == (60, 4, 3) and got.rot.shape == (60, 4, 4)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(traj, f))[:60], atol=1e-5, rtol=0)
        assert torch.equal(getattr(final, f), getattr(got, f)[-1])


@pytest.mark.parametrize("batched_params", [False, True])
def test_simulate_batch_rows_equal_simulate(drop, batched_params):
    _, tp, js, ts, traj = drop
    starts = [ts, torch_state(_state_at(js, traj, 90)), torch_state(_state_at(js, traj, 140))]
    batch = trb.RigidBodyState(**{f: torch.stack([getattr(s, f) for s in starts]) for f in STATE_FIELDS})
    params = tp
    if batched_params:
        params = trb._map_tensors(tp, lambda v: v[None].repeat(3, *([1] * v.dim())))
    got, final = trb.simulate_batch(params, batch, n_steps=25, device="cpu")
    assert got.pos.shape == (3, 25, 4, 3) and final.pos.shape == (3, 4, 3)
    for i, s in enumerate(starts):
        one, one_final = trb.simulate(tp, s, n_steps=25, device="cpu")
        for f in STATE_FIELDS:
            np.testing.assert_allclose(getattr(got, f)[i].numpy(), getattr(one, f).numpy(), atol=1e-6, rtol=0)
            np.testing.assert_allclose(getattr(final, f)[i].numpy(), getattr(one_final, f).numpy(), atol=1e-6, rtol=0)


def test_simulate_defaults_to_the_card_and_raises_without_one(drop, monkeypatch):
    _, tp, _, ts, _ = drop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = scene(ts)
    for call in (lambda: trb.simulate(tp, ts, n_steps=2),
                 lambda: trb.simulate_batch(tp, batch, n_steps=2),
                 lambda: trb.simulate_batch_eager(tp, batch, n_steps=2),
                 lambda: trb.RigidBodyState.rest(np.zeros((2, 3)), np.ones((2, 4))),
                 lambda: thf.Heightfield.flat()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

