"""Port parity, physics at rest: the reference's own rest gates on the torch stepper.

The scenarios of ``tests/test_physics.py`` and of the crossed thin boxes in
``tests/test_physics_contacts.py`` (with its counterfactual, the edge pass
masked off) are padded to one shape and run as ONE ``simulate_batch`` with a
set of params per scene, on the CPU; each gate then reads its scene at its
own step count.  The trajectories are chaotic after first contact, so what
is held is the reference's gate on the rest state, not its numbers; only
the flat box, whose drop is symmetric, is also held to the reference's rest
height, within 2 mm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pegasus_tpu.physics import rigid_body as jrb

from pegasus_tpu_torch.physics import rigid_body as trb
from pegasus_tpu_torch.utils import quaternion as tq

from test_torch_physics import STATE_FIELDS, both_params, box_params_np, box_points

torch.set_num_threads(2)

N_BODIES = 3
IDENTITY = (1.0, 0.0, 0.0, 0.0)
CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)


def _radius_cube(fields):
    """tests/test_physics.py::box_params leaves ``half_extents`` to the
    default: a cube from the bounding-sphere radius."""
    fields = dict(fields)
    fields.pop("half_extents")
    return fields


def _scenarios():
    """name -> (param fields, start pos [3,3], start rot [3,4], steps); a
    scene with one box leaves body 2 as padding."""
    he = (0.05, 0.05, 0.08)
    face_pts = lambda h: box_points(h, with_edges=False)  # corners + face centres, 14 points
    one = lambda h: _radius_cube(box_params_np([h], [1.0], points=[face_pts(h)]))
    two = lambda h: _radius_cube(box_params_np([h, h], [1.0, 1.0], points=[face_pts(h)] * 2))
    tilt = np.roll(Rotation.from_euler("xy", [0.4, 0.3]).as_quat(), 1)
    stack_he = (0.06, 0.06, 0.04)
    stack = box_params_np([stack_he] * 2, [1.0, 1.0], points=[face_pts(stack_he)] * 2)
    stack["radius"][:] = float(np.linalg.norm(stack_he))
    stack["half_extents"][:] = stack_he
    he1, he2 = (0.25, 0.03, 0.03), (0.03, 0.25, 0.03)
    crossed = box_params_np([he1, he2], [0.5, 0.2], points=[CORNERS * he1, CORNERS * he2], friction=0.6)
    no_edge = dict(crossed, edge_mask=np.zeros((3, 12), bool))
    far = (5.0, 5.0, 0.0)  # where a padded body's origin waits
    return {
        "flat_box": (one(he), [(0, 0, 0), (0, 0, 0.3), far], [IDENTITY] * 3, 310),
        "tilted_box": (one((0.06,) * 3), [(0, 0, 0), (0, 0, 0.25), far], [IDENTITY, tilt, IDENTITY], 600),
        "energy": (one(he), [(0, 0, 0), (0, 0, 0.5), far], [IDENTITY] * 3, 500),
        "two_boxes": (two(he), [(0, 0, 0), (0, 0, 0.2), (0.01, 0, 0.5)], [IDENTITY] * 3, 600),
        "stack": (stack, [(0, 0, 0), (0, 0, 0.05), (0.008, 0.004, 0.25)], [IDENTITY] * 3, 800),
        "crossed": (crossed, [(0, 0, 0), (0, 0, he1[2]), (0, 0, 0.14)], [IDENTITY] * 3, 1500),
        "crossed_no_edge_pass": (no_edge, [(0, 0, 0), (0, 0, he1[2]), (0, 0, 0.14)], [IDENTITY] * 3, 1500),
    }


def _padded(tp: trb.RigidBodyParams, n_points: int) -> trb.RigidBodyParams:
    """One scene's params padded to N_BODIES bodies (the extra one masked
    off, massless) and ``n_points`` point slots."""
    def pad(v, axis, size, value):
        if v.shape[axis] == size:
            return v
        shape = list(v.shape)
        shape[axis] = size - v.shape[axis]
        return torch.cat([v, torch.full(shape, value, dtype=v.dtype)], dim=axis)

    fill = dict(inv_mass=0.0, inv_inertia=0.0, points=0.0, point_mask=False, radius=1e-3,
                friction=0.5, restitution=0.0, body_mask=False, half_extents=1e-3, plane_d=1e-3,
                plane_group=0, edge_a=0.0, edge_b=0.0, edge_mask=False)
    out = {}
    for name, value in fill.items():
        v = getattr(tp, name)
        if name in ("points", "point_mask"):
            v = pad(v, 1, n_points, value)
        out[name] = pad(v, 0, N_BODIES, value)
    out["plane_n"] = pad(tp.plane_n, 0, N_BODIES, 0.0)
    out["plane_n"][tp.plane_n.shape[0]:] = tp.plane_n[0]
    return trb.RigidBodyParams(**out)


@pytest.fixture(scope="module")
def rest():
    """{name: (trajectory of that scene up to its own step count, fields)}."""
    scenarios = _scenarios()
    n_points = max(f["points"].shape[1] for f, _, _, _ in scenarios.values())
    params, pos, rot = [], [], []
    for fields, p, r, _ in scenarios.values():
        n = fields["inv_mass"].shape[0]
        _, tp = both_params(fields)
        params.append(_padded(tp, n_points))
        pos.append(np.asarray(p, np.float32))
        rot.append(np.asarray(r, np.float32))
    batch = trb.RigidBodyParams(**{
        f: torch.stack([getattr(p, f) for p in params])
        for f in ("inv_mass", "inv_inertia", "points", "point_mask", "radius", "friction",
                  "restitution", "body_mask", "half_extents", "plane_n", "plane_d", "plane_group",
                  "edge_a", "edge_b", "edge_mask")})
    state0 = trb.RigidBodyState.rest(np.stack(pos), np.stack(rot), device="cpu")
    steps = max(s for _, _, _, s in scenarios.values())
    traj, _ = trb.simulate_batch(batch, state0, n_steps=steps, device="cpu")
    assert traj.pos.shape == (len(scenarios), steps, N_BODIES, 3)
    return {name: ({f: getattr(traj, f)[i, :s].numpy() for f in STATE_FIELDS}, fields)
            for i, (name, (fields, _, _, s)) in enumerate(scenarios.items())}


def _rotmat(q):
    return tq.quat_to_rotmat(torch.tensor(q)).numpy()


def check_flat_box(traj):
    # came to rest, its bottom face on z = 0, still flat; the env never moved
    assert np.linalg.norm(traj["linvel"][-1, 1]) < 0.1
    assert np.linalg.norm(traj["angvel"][-1, 1]) < 1.0
    assert abs(traj["pos"][-1, 1, 2] - 0.08) < 0.02
    assert abs(_rotmat(traj["rot"][-1, 1])[2, 2]) > 0.99
    np.testing.assert_allclose(traj["pos"][:, 0], 0.0, atol=1e-6)
    assert traj["pos"].shape[0] == 310


def check_tilted_box(traj):
    # one body axis within ~8 degrees of +-z: it rests on a face, not an edge
    assert np.abs(_rotmat(traj["rot"][-1, 1])[2, :]).max() > 0.99
    assert np.linalg.norm(traj["linvel"][-1, 1]) < 0.1
    assert abs(traj["pos"][-1, 1, 2] - 0.06) < 0.02


def check_energy(traj):
    z = traj["pos"][:, 1, 2]
    assert z.min() > -0.05  # never tunnels through the floor
    assert z.max() <= 0.5 + 1e-4  # never gains energy
    assert np.isfinite(traj["pos"]).all()


def check_two_boxes(traj):
    assert np.linalg.norm(traj["pos"][-1, 1] - traj["pos"][-1, 2]) > 0.1


def check_stack(traj):
    z = traj["pos"][-1, :, 2]
    assert abs(z[1] - 0.04) < 0.02, z
    assert 0.09 < z[2] < 0.16, z
    assert np.linalg.norm(traj["linvel"][-1, 2]) < 0.15
    assert np.linalg.norm(traj["pos"][-1, 2, :2] - traj["pos"][-1, 1, :2]) < 0.06  # stacked, not beside


def check_crossed(traj):
    rest_z = 2 * 0.03 + 0.03  # resting across the lower box's top
    assert abs(traj["pos"][-1, 2, 2] - rest_z) < 0.012
    assert abs(traj["pos"][-1, 1, 2] - 0.03) < 0.012
    assert np.linalg.norm(traj["linvel"][-1, 2]) < 0.2


def check_crossed_no_edge_pass(traj):
    # the counterfactual: without edge-edge contacts the upper box falls
    # THROUGH the lower one, so "crossed" really isolates the edge pass
    assert traj["pos"][-1, 2, 2] < 0.09 - 0.025


CHECKS = {
    "flat_box": check_flat_box, "tilted_box": check_tilted_box, "energy": check_energy,
    "two_boxes": check_two_boxes, "stack": check_stack, "crossed": check_crossed,
    "crossed_no_edge_pass": check_crossed_no_edge_pass,
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_rest_gate(rest, name):
    traj, _ = rest[name]
    assert np.isfinite(traj["pos"]).all() and np.isfinite(traj["rot"]).all()
    CHECKS[name](traj)


def test_padded_body_never_moves(rest):
    for name in ("flat_box", "tilted_box", "energy"):
        traj, _ = rest[name]
        assert (traj["pos"][:, 2] == np.float32([5.0, 5.0, 0.0])).all(), name
        assert (traj["linvel"][:, 2] == 0).all() and (traj["angvel"][:, 2] == 0).all(), name


def test_flat_box_rest_height_matches_reference(rest):
    traj, fields = rest["flat_box"]
    jp, _ = both_params(fields)
    state0 = jrb.RigidBodyState.rest(
        pos=np.array([[0, 0, 0], [0.0, 0.0, 0.3]], np.float32),
        rot=np.array([IDENTITY, IDENTITY], np.float32),
    )
    _, final = jrb.simulate(jp, state0, n_steps=310)
    assert abs(float(final.pos[1, 2]) - traj["pos"][-1, 1, 2]) < 0.002
    assert abs(float(jnp.linalg.norm(final.linvel[1])) - np.linalg.norm(traj["linvel"][-1, 1])) < 0.05
