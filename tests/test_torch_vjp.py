"""Port parity, the differentiable compositor: ``ops/composite_vjp.py`` of
``pegasus_tpu_torch`` against autograd and against ``pegasus_tpu``'s
``rasterize_pallas_diff`` (its custom-VJP Pallas pair in interpret mode).

The port runs on the CPU, where ``CompositeTiles`` takes the plain forward
and the plain backward, ``composite_tiles_backward_torch``.  Tolerances:

* plain backward vs autograd through the plain forward (same float32
  arithmetic, sums in another order): cosine > 0.99999, rtol 1e-3,
  atol 1e-6.  The backward reads its totals off the forward's output and
  walks once, so on a long tile the suffix S - prefix cancels; the
  pile-up scene holds one tile of about 2,000 entries to test that;
* port vs JAX (two implementations, two binnings whose depth ties break
  differently): the JAX package's own tolerances between two backends,
  tests/test_pallas_vjp.py: loss rtol 1e-4, cosine > 0.999, rtol 2e-2,
  atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.cloud import merge as jmerge
from pegasus_tpu.ops.pallas_vjp import rasterize_pallas_diff, rasterize_projected_pallas
from pegasus_tpu.ops.projection import project_gaussians as j_project
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane

from pegasus_tpu_torch.interop import (CAMERA_FIELDS, CLOUD_FIELDS,
                                       camera_from_numpy, cloud_from_numpy)
from pegasus_tpu_torch.ops.binning import bin_splats
from pegasus_tpu_torch.ops.composite_vjp import (composite_tiles_backward,
                                                 composite_tiles_backward_torch,
                                                 composite_tiles_diff,
                                                 entry_grads_to_splats,
                                                 rasterize_diff,
                                                 rasterize_projected_diff)
from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import (CHUNK_ENTRIES, composite_tiles_torch,
                                                   num_channels, tile_items)
from pegasus_tpu_torch.testing import make_tile_pileup

torch.set_num_threads(1)

PARAMS = ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot")
W = H = 32


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(a @ b) / (na * nb) if na and nb else 0.0


@pytest.fixture(scope="module")
def scene():
    """tests/test_pallas_vjp.py's scene and camera, in both packages."""
    rng = np.random.default_rng(0)
    jscene = jmerge([j_plane(rng, n=300, size=1.0),
                     j_box(rng, n=150, center=(0, 0, 0.08), object_id=1)])
    jcam = JCamera.look_at(eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
                           fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=W, height=H)
    cloud = cloud_from_numpy({f: np.asarray(getattr(jscene, f)) for f in CLOUD_FIELDS}, device="cpu")
    d = {f: np.asarray(getattr(jcam, f)) for f in CAMERA_FIELDS}
    d["width"], d["height"] = W, H
    return jscene, jcam, cloud, camera_from_numpy(d, device="cpu")


def j_loss_weights(out):
    """A loss touching every output channel group (test_pallas_vjp.py:65-74)."""
    return (
        jnp.sum(out.rgb * jnp.cos(jnp.arange(out.rgb.size).reshape(out.rgb.shape)))
        + 0.3 * jnp.sum(out.depth * 0.05)
        + 0.2 * jnp.sum(out.alpha**2)
        + 0.7 * jnp.sum(out.seg_weights[..., 1])
        + 0.4 * jnp.sum(out.vis_weights**2)
        + 0.6 * jnp.sum(out.amodal[..., 1] * 0.5)
    )


def t_loss_weights(out):
    n = out.rgb.numel()
    return (
        torch.sum(out.rgb * torch.cos(torch.arange(n, dtype=torch.float32).reshape(out.rgb.shape)))
        + 0.3 * torch.sum(out.depth * 0.05)
        + 0.2 * torch.sum(out.alpha**2)
        + 0.7 * torch.sum(out.seg_weights[..., 1])
        + 0.4 * torch.sum(out.vis_weights**2)
        + 0.6 * torch.sum(out.amodal[..., 1] * 0.5)
    )


def test_plain_backward_matches_autograd(scene):
    """(a) composite_tiles_backward_torch against autograd through
    composite_tiles_torch, on the same bins and a seeded cotangent."""
    _, _, cloud, cam = scene
    k = 2
    bins = bin_splats(project_gaussians(cloud, cam), W, H)
    g = torch.tensor(np.random.default_rng(1).normal(size=(H, W, num_channels(k))), dtype=torch.float32)
    params = bins.params.clone().requires_grad_(True)
    (composite_tiles_torch(bins._replace(params=params), W, H, k) * g).sum().backward()
    out, partials = composite_tiles_torch(bins, W, H, k, return_partials=True)
    entry_grad = composite_tiles_backward(bins, g, out, partials, W, H, k)  # CPU: the plain version
    # the chunk of entries per step changes only the order of the sums
    torch.testing.assert_close(
        entry_grad, composite_tiles_backward_torch(bins, g, out, partials, W, H, k, chunk=7),
        rtol=1e-3, atol=1e-4)
    assert_splat_grads_agree(entry_grads_to_splats(bins, entry_grad), params.grad)


def assert_splat_grads_agree(got, want):
    """Per parameter row: cosine > 0.99999, rtol 1e-3, atol 1e-6; rows
    P_RADIUS and P_OBJ exactly zero."""
    assert torch.all(got[10:] == 0)
    for r in range(10):
        assert cosine(got[r], want[r]) > 0.99999, r
        np.testing.assert_allclose(got[r].numpy(), want[r].numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=f"row {r}")


def pileup_bins(chunk_entries, k, seed=2):
    """64x40 pile-up: tile 0 holds ~2,000 entries, tiles 1-3 hold C - 1, C
    and C + 1, tile 9 (on the ragged bottom row) some, every other none."""
    c = chunk_entries
    proj = make_tile_pileup(np.random.default_rng(seed), {0: 2_000, 1: c - 1, 2: c, 3: c + 1, 9: 60},
                            64, 40, k, device="cpu")
    return bin_splats(proj, 64, 40)


@pytest.mark.parametrize("chunk_entries,k", [(CHUNK_ENTRIES, 1), (CHUNK_ENTRIES, 3), (150, 3)])
def test_one_walk_backward_matches_autograd_on_a_long_tile(chunk_entries, k):
    """The one-walk plain backward, fed the forward's output and partials,
    against autograd through the plain forward, where one tile's suffix
    S - prefix runs over ~2,000 entries (several work items)."""
    bins = pileup_bins(chunk_entries, k)
    count = bins.tile_count.tolist()
    assert count[0] == 2_000 and count[1:4] == [chunk_entries - 1, chunk_entries, chunk_entries + 1]
    assert tile_items(bins, chunk_entries)[0][:4].tolist() == [-(-2_000 // chunk_entries), 1, 1, 2]
    g = torch.tensor(np.random.default_rng(3).normal(size=(40, 64, num_channels(k))),
                     dtype=torch.float32)
    params = bins.params.clone().requires_grad_(True)
    (composite_tiles_torch(bins._replace(params=params), 64, 40, k, chunk_entries=chunk_entries)
     * g).sum().backward()
    out, partials = composite_tiles_torch(bins, 64, 40, k, chunk_entries=chunk_entries,
                                          return_partials=True)
    entry_grad = composite_tiles_backward(bins, g, out, partials, 64, 40, k,
                                          chunk_entries=chunk_entries)
    assert_splat_grads_agree(entry_grads_to_splats(bins, entry_grad), params.grad)


def test_item_split_changes_only_rounding():
    """The plain forward composited in work items of 150 entries, combined
    in order, against one item per tile; and the one-walk backward at both
    splits.  Same entries, same order: float32 rounding only."""
    k = 3
    bins = pileup_bins(150, k)
    whole, whole_p = composite_tiles_torch(bins, 64, 40, k, chunk_entries=10**6, return_partials=True)
    split, split_p = composite_tiles_torch(bins, 64, 40, k, chunk_entries=150, return_partials=True)
    torch.testing.assert_close(split, whole, rtol=1e-5, atol=1e-6)
    g = torch.tensor(np.random.default_rng(4).normal(size=whole.shape), dtype=torch.float32)
    torch.testing.assert_close(
        composite_tiles_backward(bins, g, split, split_p, 64, 40, k, chunk_entries=150),
        composite_tiles_backward(bins, g, whole, whole_p, 64, 40, k, chunk_entries=10**6),
        rtol=1e-3, atol=1e-4)


def test_backward_needs_the_forward_state(scene):
    """No output or partials -> the backward raises (it never re-walks to
    rebuild them); autograd refuses an in-place edit of the saved output
    (its version check, or the view rule where the output is a view)."""
    _, _, cloud, cam = scene
    k = 2
    bins = bin_splats(project_gaussians(cloud, cam), W, H)
    out, partials = composite_tiles_torch(bins, W, H, k, return_partials=True)
    g = torch.ones_like(out)
    with pytest.raises(ValueError, match="partials"):
        composite_tiles_backward(bins, g, out, None, W, H, k)
    with pytest.raises(ValueError, match="partials"):
        composite_tiles_backward(bins, g, None, partials, W, H, k)
    with pytest.raises(ValueError, match="partials: want"):
        composite_tiles_backward(bins, g, out, partials[:-1], W, H, k)
    params = bins.params.clone().requires_grad_(True)
    y = composite_tiles_diff(bins._replace(params=params), W, H, k)
    with pytest.raises(RuntimeError, match="modified by an inplace operation|modified inplace"):
        y.mul_(2.0)
        y.sum().backward()


def test_grad_parity_vs_jax(scene):
    """(b) gradients w.r.t. every cloud field: port rasterize_diff against
    JAX rasterize_pallas_diff(interpret=True), K = 2."""
    jscene, jcam, cloud, cam = scene

    def j_loss(params):
        out = rasterize_pallas_diff(jscene.replace(**params), jcam, max_objects=2,
                                    chunk=128, interpret=True)
        return j_loss_weights(out)

    jl, jg = jax.value_and_grad(j_loss)({p: getattr(jscene, p) for p in PARAMS})

    params = {p: getattr(cloud, p).clone().requires_grad_(True) for p in PARAMS}
    tl = t_loss_weights(rasterize_diff(cloud.replace(**params), cam, max_objects=2))
    tl.backward()

    assert np.isclose(float(tl.detach()), float(jl), rtol=1e-4), (float(tl.detach()), float(jl))
    for p in PARAMS:
        a, b = params[p].grad.numpy(), np.asarray(jg[p])
        assert cosine(a, b) > 0.999, (p, cosine(a, b))
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-4, err_msg=p)


@pytest.fixture(scope="module")
def probes(scene):
    """The screen-space probes of both packages on one loss: the gradient
    of a zero mean2d offset (signed) and of the AbsGS sink (|per-tile|)."""
    jscene, jcam, cloud, cam = scene
    n = jscene.num_splats

    def j_loss(offset, sink):
        proj = j_project(jscene, jcam)
        proj = proj._replace(mean_x=proj.mean_x + offset[:, 0], mean_y=proj.mean_y + offset[:, 1])
        out = rasterize_projected_pallas(proj, W, H, jnp.zeros(3), max_objects=2, chunk=128,
                                         interpret=True, abs_grad_sink=sink)
        return jnp.sum((jnp.clip(out.rgb, 0, 1) - 0.25) ** 2)

    z = jnp.zeros((n, 2), jnp.float32)
    j_off, j_abs = jax.grad(j_loss, argnums=(0, 1))(z, z)

    offset = torch.zeros((n, 2), requires_grad=True)
    sink = torch.zeros((n, 2), requires_grad=True)
    proj = project_gaussians(cloud, cam)
    proj = proj._replace(mean_x=proj.mean_x + offset[:, 0], mean_y=proj.mean_y + offset[:, 1])
    out = rasterize_projected_diff(proj, W, H, max_objects=2, abs_grad_sink=sink)
    torch.sum((torch.clamp(out.rgb, 0, 1) - 0.25) ** 2).backward()
    return (np.asarray(j_off), np.asarray(j_abs)), (offset.grad.numpy(), sink.grad.numpy())


def test_mean2d_offset_probe_matches_jax(probes):
    """(c) the densification probe: a zero offset added after projection."""
    (j_off, _), (t_off, _) = probes
    assert np.linalg.norm(t_off) > 0
    assert cosine(t_off, j_off) > 0.999


def test_abs_grad_sink_matches_jax(probes):
    """(i) AbsGS: the per-splat sum of |per-entry mean2d gradients|."""
    (j_off, j_abs), (t_off, t_abs) = probes
    assert cosine(t_abs, j_abs) > 0.999
    np.testing.assert_allclose(t_abs, j_abs, rtol=2e-2, atol=2e-4)
    # |per-tile| sums dominate the signed sum and vanish exactly with it
    assert np.all(t_abs >= np.abs(t_off) * (1 - 1e-4) - 1e-12)
    np.testing.assert_array_equal(np.any(t_abs > 0, axis=1), np.any(t_off != 0, axis=1))


def test_dead_splats_get_zero_grads(scene):
    """(d) dead slots receive exact zeros, live ones do not."""
    _, _, cloud, cam = scene
    alive = torch.ones(cloud.num_splats, dtype=torch.bool)
    alive[-50:] = False
    xyz = cloud.xyz.clone().requires_grad_(True)
    out = rasterize_diff(cloud.replace(alive=alive, xyz=xyz), cam, max_objects=2)
    out.rgb.sum().backward()
    assert torch.all(xyz.grad[-50:] == 0.0)
    assert torch.any(xyz.grad[:-50] != 0.0)
