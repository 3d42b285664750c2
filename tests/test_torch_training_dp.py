"""Port parity, data-parallel training: ``GSTrainer.make_dp_train_step`` and ``train(mesh=)``.

``tests/test_training_dp.py``'s case in both packages: a 400-splat box, 32x32
views rendered by the JAX golden, 200 seed points, capacity 512.  The JAX
trainer steps a 4-camera batch on 4 of its virtual CPU devices (``shard_map``
and ``pmean`` / ``psum``); the port steps the same state, carried across as
numpy, on a mesh of 4 CPU lanes.  Tolerances are one train step's
(``tests/test_torch_training.py``): loss rtol 1e-4, parameters and Adam's
first moment rtol 1e-3 / atol 2e-5, the densify statistic rtol 5e-2 / atol
1e-7, the visibility count exact.  Against the port's own hand-made batch
update (one ``_apply_grads`` of the mean of four single-view gradients) the
step agrees to 2e-6, the JAX test's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.parallel.mesh import make_mesh as j_make_mesh
from pegasus_tpu.training.trainer import GSTrainer as JTrainer
from pegasus_tpu.training.trainer import TrainConfig as JConfig
from pegasus_tpu.training.trainer import init_from_points as j_init

from pegasus_tpu_torch.interop import CAMERA_FIELDS, cameras_from_numpy, train_state_from_numpy
from pegasus_tpu_torch.parallel.mesh import make_mesh
from pegasus_tpu_torch.training.trainer import GROUPS, GSTrainer, TrainConfig

from test_torch_training import assert_state_close, j_state_to_numpy
from test_torch_training import setup as _single_step_setup  # noqa: F401  (the shared fixture)

torch.set_num_threads(1)

setup = _single_step_setup


def cpu_lanes(n, axis="batch"):
    return make_mesh((n,), (axis,), ["cpu"] * n)


@pytest.fixture(scope="module")
def both(setup):
    """One state in both packages, the four cameras as a stacked batch (JAX)
    and as the list made from it (port), and the four images."""
    jcams, _, gts, pts, colors = setup
    jconfig = JConfig(capacity=512, densify_from_iter=10**9)
    jt = JTrainer(jconfig, width=32, height=32)
    s0 = jt.init_state(j_init(pts, colors, jconfig), spatial_lr_scale=0.5)
    cams_b = jax.tree.map(lambda *x: jnp.stack(x), *jcams)
    stacked = {f: np.asarray(getattr(cams_b, f)) for f in CAMERA_FIELDS}
    stacked["width"], stacked["height"] = 32, 32
    tcams = cameras_from_numpy(stacked, device="cpu")
    tt = GSTrainer(TrainConfig(capacity=512, densify_from_iter=10**9), width=32, height=32, device="cpu")
    return jt, s0, cams_b, tt, tcams, gts


def test_camera_batch_crosses_as_numpy(both, setup):
    _, _, _, _, tcams, _ = both
    _, single, *_ = setup
    assert len(tcams) == 4
    for a, b in zip(tcams, single):
        assert torch.equal(a.R_w2c, b.R_w2c) and torch.equal(a.t_w2c, b.t_w2c)
        assert (a.fovx, a.fovy, a.width, a.height) == (b.fovx, b.fovy, 32, 32)


def test_dp_step_matches_reference(both):
    """(d) one DP step over 4 cameras on 4 lanes against the JAX trainer's
    on 4 virtual devices."""
    jt, s0, cams_b, tt, tcams, gts = both
    j_step = jt.make_dp_train_step(j_make_mesh((4,), ("batch",), jax.devices()[:4]))
    s1, m1 = j_step(s0, cams_b, jnp.stack([jnp.asarray(g) for g in gts]))

    t0 = train_state_from_numpy(j_state_to_numpy(s0), device="cpu")
    t1, m2 = tt.make_dp_train_step(cpu_lanes(4))(t0, tcams, torch.tensor(np.stack(gts)))

    assert np.isclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    assert set(m2) == set(m1)
    want = j_state_to_numpy(s1)
    assert_state_close(t1, want, rtol=1e-3, atol=2e-5)
    for g in GROUPS:
        np.testing.assert_allclose(t1.mu[g].numpy(), want["mu"][g], rtol=1e-3, atol=2e-5, err_msg=g)
    np.testing.assert_allclose(t1.xyz_grad_accum.numpy(), want["xyz_grad_accum"], rtol=5e-2, atol=1e-7)
    np.testing.assert_array_equal(t1.denom.numpy(), want["denom"])
    # one update: the step and Adam's count advance by one, not by the batch
    assert (t1.count, t1.step) == (want["count"]["xyz"], want["step"]) == (1, 1)
    assert float(t1.denom.max()) == 4.0  # a splat seen by every view counts four times


@pytest.mark.parametrize("n_lanes,abs_grad", [(4, False), (2, False), (1, False), (4, True)])
def test_dp_matches_batch_average(both, n_lanes, abs_grad):
    """The DP step == one ``_apply_grads`` of the batch-averaged gradient
    with the densify statistics SUMMED over the views, on 4, 2 and 1 lanes
    (2 and 4 cameras per lane), and with the AbsGS probe (it sums like g2d).
    atol 2e-6, as tests/test_training_dp.py."""
    _, s0, _, _, tcams, gts = both
    tt = GSTrainer(TrainConfig(capacity=512, densify_from_iter=10**9, densify_abs_grad=abs_grad),
                   width=32, height=32, device="cpu")
    state = train_state_from_numpy(j_state_to_numpy(s0), device="cpu")
    images = [torch.tensor(g) for g in gts]
    got, metrics = tt.make_dp_train_step(cpu_lanes(n_lanes))(state, tcams, images)

    grads, losses, g2d_sum, denom_sum = [], [], 0.0, 0.0
    for cam, img in zip(tcams, images):
        loss, _, pg, og = tt._loss_and_grads(state, cam, img)
        g2d, denom = tt._densify_stats(og)
        grads.append(pg)
        losses.append(float(loss))
        g2d_sum, denom_sum = g2d_sum + g2d, denom_sum + denom
    want = tt._apply_grads(state, {g: sum(pg[g] for pg in grads) / 4.0 for g in GROUPS},
                           g2d_sum, denom_sum)
    for g in GROUPS:
        torch.testing.assert_close(getattr(got.cloud, g), getattr(want.cloud, g), rtol=0, atol=2e-6)
    torch.testing.assert_close(got.xyz_grad_accum, want.xyz_grad_accum, rtol=0, atol=2e-6)
    assert torch.equal(got.denom, want.denom) and float(got.denom.sum()) > 0
    assert abs(float(metrics["loss"]) - np.mean(losses)) <= 1e-6
    assert (got.step, got.count) == (state.step + 1, state.count + 1)


def test_dp_step_checks_its_batch_and_mesh(both):
    _, s0, _, tt, tcams, gts = both
    state = train_state_from_numpy(j_state_to_numpy(s0), device="cpu")
    images = [torch.tensor(g) for g in gts]
    with pytest.raises(ValueError, match=r"camera batch \(3\) must be a multiple of the mesh size \(2\)"):
        tt.make_dp_train_step(cpu_lanes(2))(state, tcams[:3], images[:3])
    with pytest.raises(ValueError, match="1-D 'batch' mesh"):
        tt.make_dp_train_step(cpu_lanes(2, "scene"))


def test_train_loop_with_mesh_lowers_the_loss(both):
    """``train(mesh=)`` draws a mesh-size camera batch per iteration (the
    reference's draw: ``choice`` without replacement while the views last)
    and 10 iterations lower the loss."""
    _, s0, _, tt, tcams, gts = both
    state = train_state_from_numpy(j_state_to_numpy(s0), device="cpu")
    images = [torch.tensor(g) for g in gts]
    mesh = cpu_lanes(4)
    _, first = tt.make_dp_train_step(mesh)(state, tcams, images)
    state2, last = tt.train(state, tcams, images, iterations=10, scene_extent=0.5, seed=2, mesh=mesh)
    assert (state2.step, state2.count) == (state.step + 10, state.count + 10)
    assert np.isfinite(float(last["loss"])) and float(last["loss"]) < float(first["loss"])
    # more lanes than views: the batch is drawn with replacement
    state3, _ = tt.train(state, tcams[:2], images[:2], iterations=2, scene_extent=0.5, mesh=mesh)
    assert state3.step == state.step + 2
