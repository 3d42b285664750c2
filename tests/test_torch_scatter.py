"""The backward's scatter of per-entry gradients to splats: a segmented sum
in a fixed order (``composite_vjp.sum_by_splat``) in place of
``index_add_``, whose CUDA version sums with atomics and so changes its
last bits from run to run.

The plain reference here is ``index_add_`` itself.  Tolerance 1e-6
(absolute and relative): both add the same float32 values per splat, the
segmented sum in entry order.  The bins' cached order must be exactly the
stable sort of ``entry_splat``.
"""

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.ops import binning as B
from pegasus_tpu_torch.ops.binning import TileBins, bin_splats
from pegasus_tpu_torch.ops.composite_vjp import (N_GRAD, composite_tiles_diff,
                                                 entry_grads_to_splats, sum_by_splat)
from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.testing import make_box_cloud

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-6)


def index_add_scatter(entry_splat, rows, n):
    out = torch.zeros(rows.shape[0], n)
    out.index_add_(1, entry_splat.long(), rows)
    return out


@pytest.fixture(scope="module")
def train_bins():
    """The training shape: 150k splats on a box at 512x512, K = 1."""
    cloud = make_box_cloud(np.random.default_rng(7), n=150_000, half_extents=(0.15, 0.15, 0.18),
                           rgb=(0.6, 0.4, 0.3), object_id=0, device="cpu")
    cam = Camera.look_at((0.6, 0.45, 0.5), (0, 0, 0), (0, 0, 1), np.deg2rad(55), np.deg2rad(55),
                         512, 512, device="cpu")
    return bin_splats(project_gaussians(cloud, cam), 512, 512)


def test_cached_order_is_the_stable_sort(train_bins):
    bins = train_bins
    assert bins.entry_splat.numel() > 300_000
    assert torch.equal(bins.splat_order, torch.argsort(bins.entry_splat, stable=True))
    assert torch.equal(bins.splat_count,
                       torch.bincount(bins.entry_splat.long(), minlength=bins.params.shape[1]))


def test_segmented_sum_equals_index_add_at_training_shape(train_bins):
    bins = train_bins
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_GRAD, bins.entry_splat.numel())).astype(np.float32))
    ref = index_add_scatter(bins.entry_splat, g, bins.params.shape[1])
    got = entry_grads_to_splats(bins, g)
    np.testing.assert_allclose(got[:N_GRAD].numpy(), ref.numpy(), **TOL)
    assert not got[N_GRAD:].any()


def test_segmented_sum_on_repeated_splats():
    """A random entry_splat with repeats and splats with no entry."""
    rng = np.random.default_rng(3)
    n, m = 300, 5000
    entry_splat = torch.from_numpy(rng.integers(0, n // 2, m).astype(np.int32) * 2)
    bins = TileBins(torch.zeros(B.PARAM_DIM, n), entry_splat, torch.zeros(1, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32), 1, 1, 0,
                    torch.argsort(entry_splat, stable=True),
                    torch.bincount(entry_splat.long(), minlength=n))
    rows = torch.from_numpy(rng.normal(size=(3, m)).astype(np.float32))
    got = sum_by_splat(bins, rows)
    np.testing.assert_allclose(got.numpy(), index_add_scatter(entry_splat, rows, n).numpy(), **TOL)
    assert not got[:, 1::2].any()


def test_backward_sink_equals_index_add():
    """The AbsGS sink and the parameter gradient of one backward against
    ``index_add_`` of the same per-entry rows."""
    from pegasus_tpu_torch.ops import composite_vjp

    cloud = make_box_cloud(np.random.default_rng(5), n=400, object_id=0, device="cpu")
    cam = Camera.look_at((0.3, 0.2, 0.3), (0, 0, 0), (0, 0, 1), 1.0, 1.0, 48, 40, device="cpu")
    bins = bin_splats(project_gaussians(cloud, cam), 48, 40)
    params = bins.params.clone().requires_grad_(True)
    sink = torch.zeros(params.shape[1], 2, requires_grad=True)
    seen = {}
    real = composite_vjp.composite_tiles_backward

    def spy(*args, **kw):
        seen["rows"] = real(*args, **kw)
        return seen["rows"]

    composite_vjp.composite_tiles_backward = spy
    try:
        out = composite_tiles_diff(bins._replace(params=params), 48, 40, 1, sink)
        w = torch.from_numpy(np.random.default_rng(6).normal(size=out.shape).astype(np.float32))
        (out * w).sum().backward()
    finally:
        composite_vjp.composite_tiles_backward = real
    rows = seen["rows"]
    n = params.shape[1]
    np.testing.assert_allclose(params.grad[:N_GRAD].numpy(),
                               index_add_scatter(bins.entry_splat, rows, n).numpy(), **TOL)
    np.testing.assert_allclose(sink.grad.numpy(),
                               index_add_scatter(bins.entry_splat, rows[0:2].abs(), n).T.numpy(),
                               **TOL)
    assert float(sink.grad.abs().sum()) > 0
