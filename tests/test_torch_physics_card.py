"""The physics on the card: the captured step against the op-by-op steps.

    python -m pytest -m gpu tests/test_torch_physics_card.py

Needs a CUDA device and imports nothing of JAX (the GPU machine has none),
so the drop is built here with numpy: three tilted boxes above one another,
which fall, hit the ground and each other, and pile up.  The replayed
roll-out must be bitwise the op-by-op one, also after other start states
went through the same cached program, and both must stay within float32
rounding of the CPU while the boxes fall.
"""

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.physics import rigid_body as rb

pytestmark = pytest.mark.gpu

FIELDS = ("pos", "rot", "linvel", "angvel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def three_box_drop():
    rng = np.random.default_rng(21)
    halfs = np.array([(0.05, 0.04, 0.03), (0.04, 0.04, 0.04), (0.06, 0.03, 0.02)], np.float32)
    masses = np.array([0.5, 0.3, 0.2], np.float32)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    points = np.zeros((4, 14, 3), np.float32)
    inv_inertia = np.zeros((4, 3), np.float32)
    for i, (h, m) in enumerate(zip(halfs, masses), start=1):
        points[i] = np.concatenate([signs * h, np.diag(h), -np.diag(h)])
        ext = 2 * h
        inv_inertia[i] = 12.0 / (m * np.array([ext[1]**2 + ext[2]**2, ext[0]**2 + ext[2]**2,
                                               ext[0]**2 + ext[1]**2]))
    t = torch.tensor
    params = rb.RigidBodyParams(
        inv_mass=t(np.concatenate([[0.0], 1.0 / masses]).astype(np.float32)), inv_inertia=t(inv_inertia),
        points=t(points), point_mask=t(np.arange(4)[:, None].repeat(14, 1) > 0),
        radius=t(np.concatenate([[1e-3], np.linalg.norm(halfs, axis=1)]).astype(np.float32)),
        friction=t(np.full(4, 0.5, np.float32)), restitution=t(np.zeros(4, np.float32)),
        body_mask=t(np.ones(4, bool)),
        half_extents=t(np.concatenate([[[1e-3] * 3], halfs]).astype(np.float32)),
    )
    q = rng.normal(size=(3, 4)) * 0.3 + [1, 0, 0, 0]
    rot = np.concatenate([[[1, 0, 0, 0]], q / np.linalg.norm(q, axis=1, keepdims=True)])
    pos = np.array([[0, 0, 0], [0.0, 0.0, 0.15], [0.03, 0.01, 0.30], [-0.02, 0.03, 0.45]])
    return params, rb.RigidBodyState.rest(pos[None], rot[None], device="cpu")


def test_replayed_steps_equal_op_by_op_steps(cuda):
    params, batch = three_box_drop()
    eager, _ = rb.simulate_batch_eager(params, batch, n_steps=200, device=cuda)
    first, _ = rb.simulate_batch(params, batch, n_steps=200, device=cuda)
    other = rb.RigidBodyState(**{f: getattr(first, f)[:, 100] for f in FIELDS})
    rb.simulate_batch(params, other, n_steps=30, device=cuda)
    again, final = rb.simulate_batch(params, batch, n_steps=200, device=cuda)
    assert float(first.angvel.abs().max()) > 1.0  # the boxes did hit something
    assert torch.equal(first.packed(), eager.packed()) and torch.equal(again.packed(), eager.packed())
    assert torch.equal(final.packed(), eager.packed()[:, -1])
    cpu, _ = rb.simulate_batch(params, batch, n_steps=40, device="cpu")
    np.testing.assert_allclose(first.packed()[:, :40].cpu().numpy(), cpu.packed().numpy(), atol=1e-6, rtol=0)


def test_batched_replay_rows_equal_single_scenes(cuda):
    params, batch = three_box_drop()
    single, _ = rb.simulate_batch(params, batch, n_steps=150, device=cuda)
    starts = rb.RigidBodyState(**{f: torch.cat([getattr(batch, f).to(cuda), getattr(single, f)[:, 70]])
                                  for f in FIELDS})
    both, _ = rb.simulate_batch(params, starts, n_steps=80, device=cuda)
    np.testing.assert_allclose(both.packed()[0].cpu().numpy(), single.packed()[0, :80].cpu().numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(both.packed()[1, :40].cpu().numpy(), single.packed()[0, 71:111].cpu().numpy(),
                               atol=1e-5, rtol=0)
