"""Port parity, the renderer seam: ``ops/rasterize_tiled.py`` (the
per-tile-budget renderer on capped bins), ``ops.binning.cap_bins``,
``GSTrainer(backend="tiled")``, ``rasterize_fn=`` on ``render_frame`` and
``PEGASUS``, ``compare_backends("tiled")`` and ``utils/compile_cache.py``,
against ``pegasus_tpu``.

The port runs on the CPU (``device="cpu"``), where the compositor pair takes
its plain torch versions; JAX runs on the CPU as its own tests run it.
Inputs come from numpy seeds.  The scene is ``tests/test_render_tiled.py``'s
(1,200 + 500 + 400 splats at 120x88, background 0.1).  Gates: >= 40 dB per
channel and <= 0.5 % of mask pixels (>= 0.9) disagreeing, not bitwise
equality, because the reference's depth keys keep only the top bits of the
float (ROADMAP queue 3); the training step at tests/test_torch_training.py's
tolerances.  The reference's binning never overflows here (its
``TileBins.overflow`` is asserted False), so only the cap truncates.

One difference is the reference's and is held as such: its small-bucket
core window of a splat wider than ``a_small`` tiles is not cut to the
splat's tile bbox (pegasus_tpu/ops/binning.py:353-370), so its segments
hold entries whose splat cannot reach the tile.  They add nothing to any
pixel, but a binding cap counts them.  At a binding cap the port is
therefore held against the reference's compositor on the reference's own
bins with those entries taken out (``ref_bins_in_bbox``), and the test
below them shows that they are dead entries (ROADMAP queue 3).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tiled.py -q
"""

import functools
import importlib
import json
from pathlib import Path

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.assets.registry import Asset as JAsset
from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.cloud import merge as jmerge
from pegasus_tpu.ops import binning as JB
from pegasus_tpu.ops.binning import bin_splats as j_bin
from pegasus_tpu.ops.projection import project_gaussians as j_project
from pegasus_tpu.ops.rasterize_tiled import composite_tiles_xla as j_composite_xla
from pegasus_tpu.ops.rasterize_tiled import rasterize_tiled as j_tiled
from pegasus_tpu.ops.render import render_frame as j_render_frame
from pegasus_tpu.ops.validate import compare_backends as j_compare
from pegasus_tpu.pegasus import PEGASUS as JPEGASUS
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane
from pegasus_tpu.training.trainer import GSTrainer as JTrainer
from pegasus_tpu.training.trainer import TrainConfig as JConfig
from pegasus_tpu.training.trainer import init_from_points as j_init

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import CameraBatch
from pegasus_tpu_torch.interop import (CAMERA_FIELDS, CLOUD_FIELDS, camera_from_numpy,
                                       cloud_from_numpy, train_state_from_numpy)
from pegasus_tpu_torch.ops import rasterize_cuda
from pegasus_tpu_torch.ops.binning import bin_splats, cap_bins
from pegasus_tpu_torch.ops.composite_vjp import sum_by_splat
from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs, rasterize_reference
from pegasus_tpu_torch.ops.rasterize_tiled import (composite_tiles_xla, rasterize_projected_tiled,
                                                   rasterize_tiled)
from pegasus_tpu_torch.ops.render import FrameDataPoints, render_frame
from pegasus_tpu_torch.ops.validate import compare_backends
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.training.trainer import GROUPS, GSTrainer, TrainConfig

from test_torch_pegasus import OBJECTS, _assets, _config, _run, assert_json_close
from test_torch_pegasus import recorded  # noqa: F401  (the shared fixture)
from test_torch_training import assert_state_close, j_state_to_numpy
from test_torch_training import setup as _train_setup  # noqa: F401  (the shared fixture)

torch.set_num_threads(1)

W, H = 120, 88
BG = (0.1, 0.1, 0.1)
K = 4
NO_CAP = 1024  # above the longest segment here (664 entries)
MASKS = ("seg_weights", "vis_weights", "amodal")


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak**2 / mse) if mse > 0 else np.inf


def assert_outputs_close(ref, out, min_db=40.0, max_disagree=0.005):
    """Every RenderOutputs channel >= ``min_db`` (depth against its peak),
    and the 0.9-thresholded masks disagree on <= ``max_disagree`` of pixels."""
    for name in RenderOutputs._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        peak = max(float(a.max()), 1e-6) if name == "depth" else 1.0
        assert psnr(a, b, peak) >= min_db, (name, psnr(a, b, peak))
        if name in MASKS:
            assert np.mean((a >= 0.9) != (b >= 0.9)) <= max_disagree, name


@pytest.fixture(scope="module")
def scene():
    """tests/test_render_tiled.py:27-40, in both packages."""
    rng = np.random.default_rng(7)
    env = j_plane(rng, n=1200, size=2.0)
    b1 = j_box(rng, n=500, center=(0.05, 0.0, 0.08), object_id=1)
    b2 = j_box(rng, n=400, center=(-0.15, 0.1, 0.06), object_id=2, rgb=(0.2, 0.5, 0.9),
               half_extents=(0.05, 0.05, 0.05))
    jscene = jmerge([env, b1, b2])
    jcam = JCamera.look_at(eye=(0.6, 0.5, 0.8), target=(0, 0, 0.05), up=(0, 0, 1),
                           fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=W, height=H)
    tscene = cloud_from_numpy({f: np.asarray(getattr(jscene, f)) for f in CLOUD_FIELDS}, device="cpu")
    return jscene, jcam, tscene, port_camera(jcam)


def port_camera(jcam):
    d = {f: np.asarray(getattr(jcam, f)) for f in CAMERA_FIELDS}
    d["width"], d["height"] = jcam.width, jcam.height
    return camera_from_numpy(d, device="cpu")


def reference_bins(jscene, jcam):
    """The reference's bins as its ``rasterize_projected_tiled`` makes them."""
    bins = j_bin(j_project(jscene, jcam), jcam.width, jcam.height, tile=16,
                 big_budget=min(16384, jscene.num_splats), lane_pad=128)
    assert not bool(bins.overflow)  # only the cap truncates
    return bins


def ref_bins_in_bbox(bins):
    """The reference's bins without the entries whose splat's clipped tile
    bbox (binning.py:331-345) does not hold their tile -> (bins, the number
    taken out)."""
    p = np.asarray(bins.params_t)
    start, count = np.asarray(bins.tile_start), np.asarray(bins.tile_count)
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    tile_of = lambda v, n: np.clip(np.floor(v / bins.tile), 0, n - 1)
    cols, starts, counts, removed = [], [], [], 0
    for t in range(ntx * nty):
        e = p[:, start[t]: start[t] + count[t]]
        mx, my, r = e[JB.P_MX], e[JB.P_MY], e[JB.P_RADIUS]
        inside = ((tile_of(mx - r, ntx) <= t % ntx) & (t % ntx <= tile_of(mx + r, ntx))
                  & (tile_of(my - r, nty) <= t // ntx) & (t // ntx <= tile_of(my + r, nty)))
        removed += int((~inside).sum())
        starts.append(sum(counts))
        counts.append(int(inside.sum()))
        cols.append(e[:, inside])
    params = np.concatenate(cols + [np.zeros((p.shape[0], 128), np.float32)], axis=1)
    return bins._replace(params_t=jnp.asarray(params), tile_start=jnp.asarray(starts, jnp.int32),
                         tile_count=jnp.asarray(counts, jnp.int32)), removed


# -- the renderer ---------------------------------------------------------------------------


def test_renderer_matches_reference_below_the_cap(scene):
    """At a cap above every segment: the port's ``rasterize_tiled`` against
    the reference's, and bitwise equal to the port's ``rasterize``."""
    jscene, jcam, tscene, tcam = scene
    reference_bins(jscene, jcam)
    assert int(bin_splats(project_gaussians(tscene, tcam), W, H).tile_count.max()) < NO_CAP
    ref = j_tiled(jscene, jcam, background=BG, max_objects=K, max_per_tile=NO_CAP)
    out = rasterize_tiled(tscene, tcam, background=BG, max_objects=K, max_per_tile=NO_CAP)
    assert_outputs_close(ref, out)
    plain = rasterize(tscene, tcam, background=BG, max_objects=K)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))


@pytest.mark.parametrize("cap", [24, 64])
def test_renderer_matches_reference_at_a_binding_cap(scene, cap):
    """At a cap that binds on >= 5 tiles: the port's ``rasterize_tiled``
    against the reference's ``composite_tiles_xla`` on its own bins (less
    the entries outside their splat's bbox, see the module docstring); the
    capped render differs from the uncapped one in both packages."""
    jscene, jcam, tscene, tcam = scene
    bins = bin_splats(project_gaussians(tscene, tcam), W, H)
    assert int((bins.tile_count > cap).sum()) >= 5
    jbins, _ = ref_bins_in_bbox(reference_bins(jscene, jcam))
    bg = jnp.asarray(BG, jnp.float32)
    ref = j_composite_xla(jbins, W, H, bg, max_objects=K, max_per_tile=cap)
    out = rasterize_tiled(tscene, tcam, background=BG, max_objects=K, max_per_tile=cap)
    assert_outputs_close(ref, out)
    ref_full = j_composite_xla(jbins, W, H, bg, max_objects=K, max_per_tile=NO_CAP)
    out_full = rasterize(tscene, tcam, background=BG, max_objects=K)
    assert psnr(ref.rgb, np.asarray(ref_full.rgb)) < 40
    assert psnr(out.rgb.numpy(), out_full.rgb.numpy()) < 40
    # the pieces: bins in, RenderOutputs out, the same bits
    proj = project_gaussians(tscene, tcam)
    via_bins = composite_tiles_xla(bin_splats(proj, W, H), W, H, BG, max_objects=K, max_per_tile=cap)
    via_proj = rasterize_projected_tiled(proj, W, H, BG, max_objects=K, max_per_tile=cap)
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(out, via_bins, via_proj))


def test_reference_bins_hold_dead_entries(scene):
    """The reference's segments hold entries outside their splat's tile
    bbox; without a cap they add nothing (its render on the bins without
    them agrees to >= 100 dB), with a cap they take places of the budget."""
    jscene, jcam, _, _ = scene
    bins = reference_bins(jscene, jcam)
    inside, removed = ref_bins_in_bbox(bins)
    assert removed > 0
    bg = jnp.asarray(BG, jnp.float32)
    a = j_composite_xla(bins, W, H, bg, max_objects=K, max_per_tile=NO_CAP)
    b = j_composite_xla(inside, W, H, bg, max_objects=K, max_per_tile=NO_CAP)
    for name in a._fields:
        assert psnr(getattr(a, name), getattr(b, name)) >= 100, name


def test_renderer_refuses_what_the_kernel_cannot_do(scene):
    """A tile other than 16 and an object id >= K raise, as in ``rasterize``."""
    _, _, tscene, tcam = scene
    with pytest.raises(ValueError, match="tile=8"):
        rasterize_tiled(tscene, tcam, tile=8)
    with pytest.raises(ValueError, match="max_objects"):
        rasterize_tiled(tscene, tcam, max_objects=2)


# -- cap_bins ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_bins(scene):
    """One binning of a chunk of 3 views of the scene."""
    jscene, jcam, tscene, _ = scene
    cams = [port_camera(JCamera.look_at(eye=eye, target=(0, 0, 0.05), up=(0, 0, 1),
                                        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=W, height=H))
            for eye in ((0.6, 0.5, 0.8), (-0.5, 0.4, 0.6), (0.2, -0.7, 0.5))]
    return bin_splats(project_gaussians(tscene, CameraBatch.stack(cams)), W, H)


def test_cap_bins_keeps_the_first_entries_of_every_segment(chunk_bins):
    bins, cap = chunk_bins, 24
    assert bins.n_frames == 3
    capped = cap_bins(bins, cap)
    start, count = bins.tile_start.tolist(), bins.tile_count.tolist()
    n_keep = int(capped.tile_count.sum())
    kept, dropped = [], []
    for t, (s, c) in enumerate(zip(start, count)):
        seg = bins.entry_splat[s: s + c]
        cs, cc = int(capped.tile_start[t]), int(capped.tile_count[t])
        assert cc == min(c, cap)
        assert torch.equal(capped.entry_splat[cs: cs + cc], seg[:cap]), t
        kept.append(seg[:cap])
        dropped.append(seg[cap:])
    assert torch.equal(capped.entry_splat[:n_keep], torch.cat(kept))
    assert torch.equal(capped.entry_splat[n_keep:], torch.cat(dropped))  # the rest, in order
    frames_over = {t // (bins.n_tiles_x * bins.n_tiles_y) for t, c in enumerate(count) if c > cap}
    assert frames_over == {0, 1, 2}  # the cap binds in every frame
    assert torch.equal(capped.params, bins.params) and capped.n_frames == 3


def test_cap_bins_is_the_identity_at_the_longest_segment(chunk_bins):
    longest = int(chunk_bins.tile_count.max())
    for cap in (longest, longest + 100):
        capped = cap_bins(chunk_bins, cap)
        for name, a, b in zip(chunk_bins._fields, chunk_bins, capped):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), name
    assert not torch.equal(cap_bins(chunk_bins, longest - 1).tile_count, chunk_bins.tile_count)


def test_cap_bins_regroups_the_kept_entries_by_splat(chunk_bins):
    """``splat_order`` / ``splat_count`` over the kept entries are what
    ``bin_splats`` builds for them (a stable grouping by splat, in entry
    order), the dropped entries follow in ``splat_order``, and the
    segmented sum adds the kept entries' rows only."""
    capped = cap_bins(chunk_bins, 24)
    n_keep = int(capped.tile_count.sum())
    kept = capped.entry_splat[:n_keep].long()
    assert torch.equal(capped.splat_order[:n_keep], torch.argsort(kept, stable=True))
    assert torch.equal(capped.splat_count, torch.bincount(kept, minlength=chunk_bins.splat_count.numel()))
    assert sorted(capped.splat_order[n_keep:].tolist()) == list(range(n_keep, capped.splat_order.numel()))
    rows = torch.randn((3, capped.entry_splat.numel()), generator=torch.Generator().manual_seed(2))
    rows[:, n_keep:] = float("nan")  # what an entry in no segment holds is never read
    want = torch.zeros((3, capped.params.shape[1]), dtype=torch.float64)
    want.index_add_(1, kept, rows[:, :n_keep].double())
    got = sum_by_splat(capped, rows)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# -- training -----------------------------------------------------------------------------------


def test_tiled_train_step_matches_reference(_train_setup):
    """One ``train_step`` of ``GSTrainer(cfg, None, 32, 32, bg, 24,
    "tiled")`` against the reference's tiled step from one numpy state, at
    tests/test_torch_training.py's tolerances (loss rtol 1e-4, parameters
    and Adam's first moments rtol 1e-3 / atol 2e-5, the densify statistic
    rtol 5e-2 / atol 1e-7).  The cap binds, and the step differs from the
    uncapped one."""
    jcams, tcams, gts, pts, colors = _train_setup
    cap = 24
    jconfig = JConfig(capacity=512, densify_from_iter=10_000)
    config = TrainConfig(capacity=512, densify_from_iter=10_000)
    jt = JTrainer(jconfig, None, 32, 32, (0.0, 0.0, 0.0), cap, "tiled")
    tt = GSTrainer(config, None, 32, 32, (0.0, 0.0, 0.0), cap, "tiled", device="cpu")
    assert (jt.backend, tt.backend, tt.max_per_tile) == ("tiled", "tiled", cap)
    s0 = jt.init_state(j_init(pts, colors, jconfig), spatial_lr_scale=0.5)
    t0 = train_state_from_numpy(j_state_to_numpy(s0), device="cpu")
    assert not bool(j_bin(j_project(s0.cloud, jcams[1]), 32, 32, big_budget=512, lane_pad=128).overflow)
    assert int(bin_splats(project_gaussians(t0.cloud, tcams[1]), 32, 32).tile_count.max()) > cap

    s1, m1 = jt.train_step(s0, jcams[1], jnp.asarray(gts[1]))
    t1, m2 = tt.train_step(t0, tcams[1], torch.tensor(gts[1]))
    assert np.isclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    want = j_state_to_numpy(s1)
    assert_state_close(t1, want, rtol=1e-3, atol=2e-5)
    for g in GROUPS:
        np.testing.assert_allclose(t1.mu[g].numpy(), want["mu"][g], rtol=1e-3, atol=2e-5, err_msg=g)
    np.testing.assert_allclose(t1.xyz_grad_accum.numpy(), want["xyz_grad_accum"], rtol=5e-2, atol=1e-7)

    uncapped, _ = GSTrainer(config, None, 32, 32, device="cpu").train_step(t0, tcams[1], torch.tensor(gts[1]))
    assert not torch.equal(uncapped.cloud.xyz, t1.cloud.xyz)


def test_tiled_trainer_refuses_abs_grad_and_keeps_render_fn():
    """``densify_abs_grad`` with ``"tiled"`` raises in both packages;
    ``render_fn`` is stored as the reference stores it."""
    for trainer, config in ((JTrainer, JConfig), (GSTrainer, TrainConfig)):
        kw = {} if trainer is JTrainer else {"device": "cpu"}
        with pytest.raises(ValueError, match="densify_abs_grad needs the pallas backend"):
            trainer(config(capacity=64, densify_abs_grad=True), backend="tiled", **kw)
        default = trainer(config(capacity=64), **kw).render_fn
        assert default.func.__name__ == "rasterize_tiled"
        assert default.keywords == {"max_objects": 1, "max_per_tile": 1024}
        mine = functools.partial(rasterize_tiled, max_per_tile=8)
        assert trainer(config(capacity=64), render_fn=mine, **kw).render_fn is mine
    assert GSTrainer(TrainConfig(capacity=64), device="cpu").render_fn.func is rasterize_tiled


# -- render_frame, compare_backends ------------------------------------------------------------


def test_render_frame_with_the_golden_matches_the_reference_default(scene):
    """``render_frame(..., rasterize_fn=rasterize_reference)`` against the
    reference's ``render_frame`` (whose default is its golden compositor):
    >= 60 dB per float plane (one algorithm), masks equal on >= 99.5 % of
    pixels; ``max_objects`` and keywords reach the given function."""
    jscene, jcam, tscene, tcam = scene
    colors = np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2]], np.float32)
    ref = j_render_frame(jscene, jcam, jnp.asarray(colors), BG)
    out = render_frame(tscene, tcam, torch.tensor(colors), BG, rasterize_fn=rasterize_reference)
    for name in ("rgb", "alpha", "seg_image", "vis_weights"):
        assert psnr(getattr(ref, name), getattr(out, name).numpy()) >= 60, name
    depth = np.asarray(ref.depth)
    assert psnr(depth, out.depth.numpy(), float(depth.max())) >= 60
    for name in ("mask_visib", "mask_amodal"):
        assert np.mean(np.asarray(getattr(ref, name)) != getattr(out, name).numpy()) <= 0.005, name
    calls = []

    def spy(cloud, cam, **kw):
        calls.append(kw)
        return rasterize_tiled(cloud, cam, **kw)

    got = render_frame(tscene, tcam, torch.tensor(colors), BG, 4, spy, max_per_tile=24)
    assert calls == [{"background": BG, "max_objects": 4, "max_per_tile": 24}]
    assert isinstance(got, FrameDataPoints)
    direct = rasterize_tiled(tscene, tcam, background=BG, max_objects=4, max_per_tile=24)
    assert torch.equal(got.vis_weights, direct.vis_weights[..., 1:3])


def test_compare_backends_tiled_reports_the_reference_keys(scene):
    jscene, jcam, tscene, tcam = scene
    ref = j_compare(jscene, jcam, backend="tiled", max_objects=K, background=BG)
    got = compare_backends(tscene, tcam, backend="tiled", max_objects=K, background=BG)
    assert set(ref) <= set(got)
    assert (ref["backend"], got["backend"]) == ("tiled", "tiled")
    assert ref["pass_40db"] and got["pass_40db"]
    auto = compare_backends(tscene, tcam, max_objects=K, background=BG)
    assert auto == dict(compare_backends(tscene, tcam, "cuda", K, BG), backend="cuda")
    assert auto == dict(compare_backends(tscene, tcam, "pallas", K, BG), backend="cuda")
    capped = compare_backends(tscene, tcam, backend="tiled", max_objects=K, background=BG,
                              max_per_tile=24)
    assert not capped["pass_40db"]  # a binding cap is a different render


# -- PEGASUS --------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode,cam_mode", [("static", "sequence"), ("dynamic", "random")])
def test_pegasus_with_rasterize_tiled_matches_reference(recorded, tmp_path, mode, cam_mode):
    """``PEGASUS(rasterize_fn=rasterize_tiled)`` against the reference's, on
    tests/test_torch_pegasus.py's small BOP tree at its tolerances: masks
    <= 0.5 % of pixels, depth within 1 mm on >= 99 % of covered pixels,
    rgb >= 40 dB, poses and JSON as there.  The given function renders
    every frame, one call each.  The default cap (1024) binds on one tile
    of every frame (segments reach about 2,000 entries at 80x60).  A
    tighter cap binds where the reference's dead entries take places of
    its budget (module docstring): at 512 and 256 its depth PNGs agree
    with the port's within 1 mm on 97.7 % and 90 % of pixels only."""
    root, physics_file, env_name = recorded
    env, objs = _assets(root, JAsset)
    ref = _run(JPEGASUS(gs_env_list=[env], gs_object_list=objs, rasterize_fn=j_tiled, frame_chunk=3,
                        **_config(root, tmp_path / "ref", mode, cam_mode)),
               physics_file, env_name, "tiled")
    calls, capped_tiles = [], []

    def counted(cloud, cam, **kwargs):
        calls.append(kwargs["max_objects"])
        count = bin_splats(project_gaussians(cloud, cam), cam.width, cam.height).tile_count
        capped_tiles.append(int((count > 1024).sum()))
        return rasterize_tiled(cloud, cam, **kwargs)

    env, objs = _assets(root, Asset)
    got = _run(PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", frame_chunk=3,
                       rasterize_fn=counted, **_config(root, tmp_path / "port", mode, cam_mode)),
               physics_file, env_name, "tiled")
    n_frames = len(got.viewport_cam_list)
    assert calls == [len(OBJECTS) + 1] * n_frames
    assert min(capped_tiles) >= 1  # the default cap of 1024 entries binds in every frame

    ref_root, got_root = tmp_path / "ref" / "tiled", tmp_path / "port" / "tiled"
    for rel in ("camera.json", "train/000001/scene_camera.json", "train/000001/scene_gt.json"):
        assert_json_close(json.loads((ref_root / rel).read_text()),
                          json.loads((got_root / rel).read_text()), rel)
    scene_dir = Path("train") / "000001"
    pngs = sorted(p.relative_to(ref_root / scene_dir) for p in (ref_root / scene_dir).rglob("*.png"))
    assert len(pngs) == n_frames * (3 + 2 * len(OBJECTS))
    for rel in pngs:
        a = imageio.imread(ref_root / scene_dir / rel)
        b = imageio.imread(got_root / scene_dir / rel)
        kind = rel.parts[0]
        if kind == "rgb":
            assert psnr(a / 255.0, b / 255.0) >= 40, rel
        elif kind == "depth":
            covered = (a > 0) | (b > 0)
            close = np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1
            assert not covered.any() or close[covered].mean() >= 0.99, rel
        else:
            assert (a != b).reshape(a.shape[0], a.shape[1], -1).any(-1).mean() <= 0.005, rel


# -- the compile cache --------------------------------------------------------------------------


@pytest.fixture
def fresh_cache(monkeypatch):
    """A fresh import of utils/compile_cache.py, with the build directory
    and the reuse switch restored afterwards."""
    monkeypatch.delenv("PEGASUS_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(rasterize_cuda, "_BUILD_DIR", rasterize_cuda.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(rasterize_cuda, "_REUSE_BUILDS", True)
    module = importlib.reload(importlib.import_module("pegasus_tpu_torch.utils.compile_cache"))
    yield module
    importlib.reload(module)


def test_compile_cache_relocates_once(fresh_cache, tmp_path, monkeypatch):
    d = str(tmp_path / "kernels")
    monkeypatch.setenv("PEGASUS_TPU_COMPILE_CACHE", d)
    assert fresh_cache.enable_compilation_cache() == d
    assert rasterize_cuda._BUILD_DIR == Path(d) and Path(d).is_dir()
    # idempotent: a second call, even with a path, is a no-op
    assert fresh_cache.enable_compilation_cache(str(tmp_path)) is None
    assert rasterize_cuda._BUILD_DIR == Path(d) and rasterize_cuda._REUSE_BUILDS


def test_compile_cache_path_and_default(fresh_cache, tmp_path):
    d = str(tmp_path / "given")
    assert fresh_cache.enable_compilation_cache(d) == d
    assert rasterize_cuda._BUILD_DIR == Path(d)
    fresh = importlib.reload(fresh_cache)
    rasterize_cuda._BUILD_DIR = rasterize_cuda.DEFAULT_BUILD_DIR
    assert fresh.enable_compilation_cache() == str(rasterize_cuda.DEFAULT_BUILD_DIR)
    assert rasterize_cuda.DEFAULT_BUILD_DIR == Path(rasterize_cuda.__file__).resolve().parents[1] / "csrc" / "build"


def test_compile_cache_env_zero_disables(fresh_cache, monkeypatch):
    monkeypatch.setenv("PEGASUS_TPU_COMPILE_CACHE", "0")
    assert fresh_cache.enable_compilation_cache() is None
    assert rasterize_cuda._BUILD_DIR == rasterize_cuda.DEFAULT_BUILD_DIR
    assert not rasterize_cuda._REUSE_BUILDS  # each process builds its kernels afresh


def test_compile_cache_unwritable_keeps_the_default(fresh_cache, tmp_path, capsys):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    assert fresh_cache.enable_compilation_cache(str(blocker / "sub")) is None
    assert rasterize_cuda._BUILD_DIR == rasterize_cuda.DEFAULT_BUILD_DIR
    assert "not writable" in capsys.readouterr().err


def test_entry_points_enable_the_cache(fresh_cache, tmp_path, monkeypatch):
    """``GSTrainer`` (and ``PEGASUS``) call ``enable_compilation_cache`` as
    the reference's do."""
    monkeypatch.setenv("PEGASUS_TPU_COMPILE_CACHE", str(tmp_path / "k"))
    GSTrainer(TrainConfig(capacity=64), device="cpu")
    assert rasterize_cuda._BUILD_DIR == tmp_path / "k"
    assert fresh_cache.enable_compilation_cache() is None  # already enabled
