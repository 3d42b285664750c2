"""The CUDA tile compositor and its backward against their plain torch
versions, on the card.

Every test here needs a CUDA device and ``nvcc`` (the kernels are built at
first use); without a card they skip.  Run them on a GPU machine with

    python -m pytest -m gpu tests/test_torch_kernel.py

Tolerance: both forward versions composite the same entries in the same
order in float32 and differ only in rounding (sequential products against a
cumulative product), so every channel must agree to > 60 dB.  The backward
versions recompute the same alphas and differ in rounding and in the order
of the per-entry sums (warp shuffles, then the eight warps' sums), so each
gradient row must reach a cosine of 0.99999 and a max |difference| of 1e-4
x the row's max |gradient|.  Both backward versions are fed the forward
kernel's output and partials.  Neither kernel sums a float by an atomic:
each combines its partial results in a fixed order, so two launches must
agree bitwise.  A launch over a chunk of C frames must equal the C
launches of its frames bitwise, and pass the same limits against the plain
version on the chunk.  K > 32 (a crowded scene) takes the forward's object
groups and the backward's unstaged instance: K = 33, 49 and 64 are held
to the same limits.
"""

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.camera import Camera, CameraBatch
from pegasus_tpu_torch.gs.cloud import merge
from pegasus_tpu_torch.ops.binning import bin_splats
from pegasus_tpu_torch.ops.composite_vjp import (N_GRAD, composite_tiles_backward,
                                                 composite_tiles_backward_torch,
                                                 composite_tiles_diff)
from pegasus_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import (CHUNK_ENTRIES, composite_tiles,
                                                   composite_tiles_torch,
                                                   outputs_from_channels,
                                                   rasterize)
from pegasus_tpu_torch.ops.rasterize_ref import rasterize_reference
from pegasus_tpu_torch.testing import make_box_cloud, make_plane_cloud, make_tile_pileup

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def psnr(a, b, peak=1.0):
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * np.log10(peak**2 / mse) if mse > 0 else np.inf


def channel_psnr(ref, out):
    return {
        name: psnr(getattr(ref, name), getattr(out, name),
                   max(float(ref.depth.max()), 1e-6) if name == "depth" else 1.0)
        for name in ref._fields
    }


def scene(device, n_objects=6, n_plane=20_000, n_box=2_000, seed=7):
    rng = np.random.default_rng(seed)
    objs = [
        make_box_cloud(rng, n=n_box, center=(0.1 * (i % 6) - 0.2, 0.05 * (i % 6), 0.08 + 0.02 * (i // 6)),
                       object_id=i + 1, rgb=((0.2 + 0.1 * i) % 1.0, 0.5, 0.4), device=device)
        for i in range(n_objects)
    ]
    plane = [make_plane_cloud(rng, n=n_plane, size=2.0, device=device)] if n_plane else []
    return merge(plane + objs)


def camera(view, device, width=640, height=480):
    eye, target = {"orbit": ((0.9, 0.7, 0.9), (0, 0, 0.05)),
                   "grazing": ((0.85, 0.1, 0.10), (-0.6, 0, 0.04))}[view]
    return Camera.look_at(eye=eye, target=target, up=(0, 0, 1), fovx=np.deg2rad(60),
                          fovy=np.deg2rad(47), width=width, height=height, device=device)


@pytest.mark.parametrize("view,width,height,n_objects", [
    ("orbit", 640, 480, 6),     # K = 7, the main path's shape
    ("grazing", 640, 480, 6),
    ("orbit", 70, 50, 6),       # ragged edge tiles
    ("orbit", 320, 240, 12),    # K = 13: the K <= 16 instance
    ("grazing", 320, 240, 25),  # K = 26: the K = 32 instance
    ("orbit", 320, 240, 32),    # K = 33: two object groups, the second of one object
    ("orbit", 640, 480, 48),    # K = 49: the crowded scene's K
    ("grazing", 320, 240, 63),  # K = 64: two full groups
])
def test_kernel_matches_plain(cuda, view, width, height, n_objects):
    cam = camera(view, cuda, width, height)
    k = n_objects + 1
    bins = bin_splats(project_gaussians(scene(cuda, n_objects), cam), width, height)
    got = composite_tiles(bins, width, height, k)
    want = composite_tiles_torch(bins, width, height, k)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (height, width, 5 + 3 * k + 2)
    assert torch.isfinite(got).all()
    db = channel_psnr(outputs_from_channels(want, (0, 0, 0), k), outputs_from_channels(got, (0, 0, 0), k))
    assert min(db.values()) > 60, db
    tn = 5 + 3 * k
    assert torch.allclose(got[..., tn:], want[..., tn:], atol=1e-5)  # transmittances


def test_rasterize_matches_golden_on_card(cuda):
    cam = camera("orbit", cuda, 160, 120)
    s = scene(cuda, n_plane=8_000, n_box=800)
    db = channel_psnr(rasterize_reference(s, cam, background=(0.1, 0.1, 0.1), max_objects=7),
                      rasterize(s, cam, background=(0.1, 0.1, 0.1), max_objects=7))
    assert min(db.values()) > 40, db


def test_kernel_counts_launches_and_checks_inputs(cuda):
    cam = camera("orbit", cuda, 64, 48)
    bins = bin_splats(project_gaussians(scene(cuda, n_plane=2_000, n_box=200), cam), 64, 48)
    before = composite_tiles.launches
    composite_tiles(bins, 64, 48, 7)
    composite_tiles_torch(bins, 64, 48, 7)  # the plain version does not count
    assert composite_tiles.launches == before + 1
    with pytest.raises(ValueError, match="max_objects"):
        composite_tiles(bins, 64, 48, 6)  # object id 6 needs K >= 7
    with pytest.raises(ValueError, match="tile_count"):
        composite_tiles(bins._replace(tile_count=bins.tile_count.long()), 64, 48, 7)
    with pytest.raises(ValueError, match="on cpu"):
        composite_tiles(bins._replace(entry_splat=bins.entry_splat.cpu()), 64, 48, 7)
    assert composite_tiles.launches == before + 1


def assert_rows_agree(got, want):
    """Per gradient row: cosine >= 0.99999, max |diff| <= 1e-4 max |want|."""
    for r in range(got.shape[0]):
        a, b = got[r].double(), want[r].double()
        scale = float(b.abs().max())
        if scale == 0:
            assert float(a.abs().max()) == 0, r
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        err = float((a - b).abs().max())
        assert cos >= 0.99999 and err <= 1e-4 * scale, (r, cos, err, scale)


@pytest.mark.parametrize("view,width,height,n_objects,n_plane", [
    ("orbit", 200, 152, 0, 20_000),   # K = 1, the trainer's K
    ("orbit", 70, 50, 6, 20_000),     # K = 7, ragged edge tiles
    ("grazing", 160, 120, 12, 8_000),  # K = 13: seg/vis/amodal terms at K <= 16
    ("orbit", 120, 90, 25, 0),        # K = 26, objects only: empty tiles
    ("orbit", 160, 120, 32, 8_000),   # K = 33: cotangents read from grad_out
    ("grazing", 200, 152, 48, 20_000),  # K = 49
    ("orbit", 120, 90, 63, 0),        # K = 64, objects only
])
def test_backward_kernel_matches_plain(cuda, view, width, height, n_objects, n_plane):
    cam = camera(view, cuda, width, height)
    k = n_objects + 1
    bins = bin_splats(project_gaussians(scene(cuda, n_objects, n_plane=n_plane), cam), width, height)
    if n_plane == 0:
        assert (bins.tile_count == 0).any()
    g = torch.randn((height, width, 5 + 3 * k + 2), generator=torch.Generator().manual_seed(k))
    g = g.to(cuda)
    out, partials = composite_tiles(bins, width, height, k, return_partials=True)
    got = composite_tiles_backward(bins, g, out, partials, width, height, k)
    want = composite_tiles_backward_torch(bins, g, out, partials, width, height, k)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (N_GRAD, bins.entry_splat.numel())
    assert torch.isfinite(got).all()
    assert_rows_agree(got, want)


def test_autograd_function_matches_plain_autograd(cuda):
    """CompositeTiles' gradient (both kernels) against autograd through the
    plain forward, on a tiny scene, for a loss over every channel."""
    cam = camera("orbit", cuda, 48, 40)
    k = 3
    bins = bin_splats(project_gaussians(scene(cuda, 2, n_plane=1_500, n_box=300), cam), 48, 40)
    w = torch.randn((40, 48, 5 + 3 * k + 2), generator=torch.Generator().manual_seed(0)).to(cuda)
    grads = []
    for fn in (lambda b: composite_tiles_diff(b, 48, 40, k),
               lambda b: composite_tiles_torch(b, 48, 40, k)):
        params = bins.params.clone().requires_grad_(True)
        (fn(bins._replace(params=params)) * w).sum().backward()
        grads.append(params.grad)
    assert torch.all(grads[0][10:] == 0)
    assert_rows_agree(grads[0][:N_GRAD], grads[1][:N_GRAD])


def test_backward_counts_launches_and_checks_inputs(cuda):
    cam = camera("orbit", cuda, 64, 48)
    bins = bin_splats(project_gaussians(scene(cuda, n_plane=2_000, n_box=200), cam), 64, 48)
    g = torch.ones((48, 64, 5 + 3 * 7 + 2), device=cuda)
    fwd_before = composite_tiles.launches
    out, partials = composite_tiles(bins, 64, 48, 7, return_partials=True)
    assert composite_tiles.launches == fwd_before + 1
    before = composite_tiles_backward.launches
    composite_tiles_backward(bins, g, out, partials, 64, 48, 7)
    composite_tiles_backward_torch(bins, g, out, partials, 64, 48, 7)  # the plain version does not count
    assert composite_tiles_backward.launches == before + 1
    with pytest.raises(ValueError, match="grad_out: want"):  # its K is not the output's
        composite_tiles_backward(bins, torch.ones((48, 64, 5 + 3 * 33 + 2), device=cuda),
                                 out, partials, 64, 48, 7)
    with pytest.raises(ValueError, match="grad_out on cpu"):
        composite_tiles_backward(bins, g.cpu(), out, partials, 64, 48, 7)
    with pytest.raises(ValueError, match="on cpu"):
        composite_tiles_backward(bins._replace(tile_start=bins.tile_start.cpu()), g, out, partials,
                                 64, 48, 7)
    # without the forward's state the kernel is not launched: nothing re-walks
    with pytest.raises(ValueError, match="partials"):
        composite_tiles_backward(bins, g, out, None, 64, 48, 7)
    with pytest.raises(ValueError, match="partials"):
        composite_tiles_backward(bins, g, None, partials, 64, 48, 7)
    # a strided cotangent (a slice of a wider tensor) is made contiguous
    wide = torch.ones((48, 64, 2 * g.shape[-1]), device=cuda)[..., : g.shape[-1]]
    torch.testing.assert_close(composite_tiles_backward(bins, wide, out, partials, 64, 48, 7),
                               composite_tiles_backward(bins, g, out, partials, 64, 48, 7),
                               rtol=1e-5, atol=1e-6)
    assert composite_tiles_backward.launches == before + 3
    assert composite_tiles.launches == fwd_before + 1


def pileup(device, k, chunk_entries):
    """The long-segment stress case: 128x64, tile 0 holds 10 C + 37
    entries, tiles 1-3 C - 1, C and C + 1, tile 12 a short segment, every
    other tile none."""
    c = chunk_entries
    proj = make_tile_pileup(np.random.default_rng(5), {0: 10 * c + 37, 1: c - 1, 2: c, 3: c + 1, 12: 40},
                            128, 64, k, device=device)
    bins = bin_splats(proj, 128, 64)
    assert bins.tile_count[:4].tolist() == [10 * c + 37, c - 1, c, c + 1]
    assert (bins.tile_count == 0).any()
    return bins


@pytest.mark.parametrize("k,chunk_entries", [(1, CHUNK_ENTRIES), (7, CHUNK_ENTRIES), (7, 100)])
def test_long_segments_match_plain(cuda, k, chunk_entries):
    """Both kernels on segments split across many blocks against their
    plain versions, and the forward bitwise repeatable."""
    bins = pileup(cuda, k, chunk_entries)
    out, partials = composite_tiles(bins, 128, 64, k, chunk_entries, return_partials=True)
    again = composite_tiles(bins, 128, 64, k, chunk_entries)
    want = composite_tiles_torch(bins, 128, 64, k, chunk_entries=chunk_entries)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.isfinite(out).all()
    db = channel_psnr(outputs_from_channels(want, (0, 0, 0), k), outputs_from_channels(out, (0, 0, 0), k))
    assert min(db.values()) > 60, db
    tn = 5 + 3 * k
    assert torch.allclose(out[..., tn:], want[..., tn:], atol=1e-5)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(k)).to(cuda)
    got = composite_tiles_backward(bins, g, out, partials, 128, 64, k, chunk_entries)
    got_again = composite_tiles_backward(bins, g, out, partials, 128, 64, k, chunk_entries)
    want_g = composite_tiles_backward_torch(bins, g, out, partials, 128, 64, k,
                                            chunk_entries=chunk_entries)
    torch.cuda.synchronize()
    assert torch.equal(got, got_again)
    assert torch.isfinite(got).all()
    assert_rows_agree(got, want_g)


@pytest.mark.parametrize("k", [7, 33, 49, 64])
def test_kernels_are_bitwise_repeatable(cuda, k):
    cam = camera("orbit", cuda)
    bins = bin_splats(project_gaussians(scene(cuda, k - 1), cam), 640, 480)
    g = torch.randn((480, 640, 5 + 3 * k + 2), generator=torch.Generator().manual_seed(3)).to(cuda)
    for chunk_entries in (CHUNK_ENTRIES, 64):
        assert int(bins.tile_count.max()) > chunk_entries  # some tiles of several items
        first, partials = composite_tiles(bins, 640, 480, k, chunk_entries, return_partials=True)
        assert all(torch.equal(first, composite_tiles(bins, 640, 480, k, chunk_entries))
                   for _ in range(3))
        grad = composite_tiles_backward(bins, g, first, partials, 640, 480, k, chunk_entries)
        assert all(torch.equal(grad, composite_tiles_backward(bins, g, first, partials, 640, 480,
                                                              k, chunk_entries))
                   for _ in range(3))


def assert_within_forward_limits(got, want, k):
    """The smoke's forward_vs_plain limits: every channel > 60 dB and max
    |diff| <= 1e-3 x max(1, the channel's peak)."""
    ref, out = outputs_from_channels(want, (0, 0, 0), k), outputs_from_channels(got, (0, 0, 0), k)
    db = channel_psnr(ref, out)
    assert min(db.values()) > 60, db
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(out, name)
        assert float((a - b).abs().max()) <= 1e-3 * max(1.0, float(a.abs().max())), name


@pytest.mark.parametrize("width,height,k", [(640, 480, 7), (70, 50, 7), (640, 480, 33),
                                            (640, 480, 49), (70, 50, 64)])
def test_chunk_launch_equals_frame_launches(cuda, width, height, k):
    """One launch over three views (the last with another field of view)
    against one launch per view, bitwise; a ragged frame writes nothing
    into the next."""
    cams = [camera("orbit", cuda, width, height), camera("grazing", cuda, width, height),
            Camera.look_at(eye=(0.2, 0.9, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
                           fovx=np.deg2rad(45), fovy=np.deg2rad(35), width=width, height=height,
                           device=cuda)]
    s = scene(cuda, k - 1)
    bins = bin_splats(project_gaussians(s, CameraBatch.stack(cams)), width, height)
    before = composite_tiles.launches
    chunk = composite_tiles(bins, width, height, k)
    assert composite_tiles.launches == before + 1
    assert chunk.shape == (3, height, width, 5 + 3 * k + 2)
    for f, cam in enumerate(cams):
        one = composite_tiles(bin_splats(project_gaussians(s, cam), width, height), width, height, k)
        assert torch.equal(chunk[f], one), f
    assert_within_forward_limits(chunk, composite_tiles_torch(bins, width, height, k), k)


def test_chunk_of_stress_tiles_matches_plain(cuda):
    """The long-segment pile-up in three frames (another seed each): one
    launch bitwise equal to three, within the forward limits of the plain
    version on the chunk, bitwise repeatable; the backward takes one frame."""
    c, w, h = CHUNK_ENTRIES, 128, 64
    piles = [make_tile_pileup(np.random.default_rng(5 + f),
                              {0: 10 * c + 37, 1: c - 1, 2: c, 3: c + 1, 12: 40}, w, h, 7, device=cuda)
             for f in range(3)]
    stacked = ProjectedGaussians(*(torch.stack([getattr(p, name) for p in piles])
                                   for name in ProjectedGaussians._fields))
    bins = bin_splats(stacked, w, h)
    out, partials = composite_tiles(bins, w, h, 7, return_partials=True)
    assert torch.equal(out, composite_tiles(bins, w, h, 7))
    for f in range(3):
        one = bin_splats(ProjectedGaussians(*(x[f] for x in stacked)), w, h)
        assert one.tile_count[:4].tolist() == [10 * c + 37, c - 1, c, c + 1]
        assert torch.equal(out[f], composite_tiles(one, w, h, 7)), f
    assert_within_forward_limits(out, composite_tiles_torch(bins, w, h, 7), 7)
    with pytest.raises(ValueError, match="one frame"):
        composite_tiles_backward(bins, torch.ones_like(out[0]), out[0], partials, w, h, 7)
