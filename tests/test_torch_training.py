"""Port parity, training: ``pegasus_tpu_torch.training`` (losses, knn init,
``GSTrainer`` step and densify, checkpoints), the training loader's
``read_png`` and ``interop.train_state_from_numpy`` against ``pegasus_tpu``.

The port runs on the CPU (``device="cpu"``): the compositor pair takes its
plain torch versions.  Inputs come from numpy seeds; states and weights
cross between the packages as numpy arrays.  Tolerances are stated at each
test: 1e-6 where both packages do the same float32 arithmetic, the JAX
package's own backend-vs-backend tolerances where a gradient goes through
two different compositors.
"""

import struct
import zlib

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.knn import mean_knn_dist2 as j_knn
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.training import losses as jlosses
from pegasus_tpu.training.trainer import GSTrainer as JTrainer
from pegasus_tpu.training.trainer import TrainConfig as JConfig
from pegasus_tpu.training.trainer import init_from_points as j_init

from pegasus_tpu_torch.gs.knn import mean_knn_dist2
from pegasus_tpu_torch.interop import (CAMERA_FIELDS, CLOUD_FIELDS, camera_from_numpy,
                                       train_state_from_numpy)
from pegasus_tpu_torch.io.png import read_png, write_png
from pegasus_tpu_torch.training import losses
from pegasus_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from pegasus_tpu_torch.training.trainer import GROUPS, GSTrainer, TrainConfig, init_from_points

torch.set_num_threads(1)

CLOUD_TENSORS = ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot")


def to_np(obj, fields):
    return {f: np.asarray(getattr(obj, f)) for f in fields}


def j_state_to_numpy(s) -> dict:
    """A JAX TrainState as numpy, in train_state_from_numpy's layout."""
    inner = s.opt_state.inner_states
    adam = {g: inner[g].inner_state[0] for g in GROUPS}
    return {
        "cloud": to_np(s.cloud, CLOUD_FIELDS),
        "mu": {g: np.asarray(adam[g].mu[g]) for g in GROUPS},
        "nu": {g: np.asarray(adam[g].nu[g]) for g in GROUPS},
        "count": {g: int(adam[g].count) for g in GROUPS},
        "xyz_grad_accum": np.asarray(s.xyz_grad_accum),
        "denom": np.asarray(s.denom),
        "max_radii2d": np.asarray(s.max_radii2d),
        "step": int(s.step),
        "spatial_lr_scale": float(s.spatial_lr_scale),
    }


def assert_state_close(t_state, j_dict, rtol, atol, fields=CLOUD_TENSORS):
    for f in fields:
        np.testing.assert_allclose(getattr(t_state.cloud, f).cpu().numpy(), j_dict["cloud"][f],
                                   rtol=rtol, atol=atol, err_msg=f)


# -- losses, knn, init --------------------------------------------------------------


def test_ssim_and_loss_match_reference():
    """(e) separable SSIM (shifted slices, no conv) and L1 + D-SSIM."""
    rng = np.random.default_rng(3)
    a = rng.random((40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.tensor(a), torch.tensor(b)
    np.testing.assert_allclose(float(losses.ssim(ta, tb)), float(jlosses.ssim(ja, jb)), atol=1e-6)
    t_loss, t_aux = losses.gs_loss(ta, tb, 0.2)
    j_loss, j_aux = jlosses.gs_loss(ja, jb, 0.2)
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=1e-6)
    for k in ("l1", "ssim"):
        np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]), atol=1e-6, err_msg=k)


def test_knn_matches_reference():
    """(e) mean squared distance to the 3 nearest neighbours, self excluded
    by index (a duplicate point counts at distance 0), blocks of 128.
    rtol 1e-6, plus an atol of two float32 roundings of the largest |p|^2:
    |a|^2 + |b|^2 - 2ab cancels, so the two packages' float32 products,
    summed in another order, differ on that absolute scale (measured
    9.9e-8 on distances of about 0.01)."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 0.3
    pts[17] = pts[5]  # duplicate
    want = np.asarray(j_knn(jnp.asarray(pts), k=3, block=128))
    got = mean_knn_dist2(torch.tensor(pts), k=3, block=128).numpy()
    atol = 2 * np.finfo(np.float32).eps * float((pts**2).sum(1).max())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    assert got[5] < want.max()


# -- one training step, densify, checkpoint ----------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """tests/test_training_pallas_backend.py's setup: a 400-splat box, four
    32x32 views rendered by the JAX golden, 200 seed points, capacity 512."""
    rng = np.random.default_rng(5)
    gt_cloud = j_box(rng, n=400, half_extents=(0.08, 0.08, 0.1), rgb=(0.7, 0.3, 0.2), object_id=0)
    jcams, gts = [], []
    for az in np.linspace(0, 2 * np.pi, 4, endpoint=False):
        eye = (0.5 * np.cos(az), 0.5 * np.sin(az), 0.35)
        jcams.append(JCamera.look_at(eye=eye, target=(0, 0, 0), up=(0, 0, 1),
                                     fovx=np.deg2rad(50), fovy=np.deg2rad(50), width=32, height=32))
        gts.append(np.clip(np.asarray(j_reference(gt_cloud, jcams[-1], max_objects=1, chunk=512).rgb), 0, 1))
    rng2 = np.random.default_rng(0)
    idx = rng2.choice(gt_cloud.num_splats, 200, replace=False)
    pts = np.asarray(gt_cloud.xyz)[idx] + rng2.normal(size=(200, 3)) * 0.01
    colors = rng2.random((200, 3)).astype(np.float32)
    tcams = []
    for c in jcams:
        d = to_np(c, CAMERA_FIELDS)
        d["width"], d["height"] = 32, 32
        tcams.append(camera_from_numpy(d, device="cpu"))
    return jcams, tcams, gts, pts, colors


def test_init_from_points_matches_reference(setup):
    """(f) knn-initialised isotropic splats, padded to capacity."""
    *_, pts, colors = setup
    config = TrainConfig(capacity=512)
    want = j_init(pts, colors, JConfig(capacity=512))
    got = init_from_points(pts, colors, config, device="cpu")
    for f in CLOUD_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)


def test_train_step_matches_reference(setup):
    """(g) one train_step from one state against the JAX trainer on its
    Pallas pair (interpret mode), with test_training_pallas_backend.py's
    tolerances: loss rtol 1e-4, parameters rtol 1e-3 / atol 2e-5, the
    densify statistic rtol 5e-2 / atol 1e-7; Adam's moments to the same
    parameter tolerances."""
    jcams, tcams, gts, pts, colors = setup
    jconfig = JConfig(capacity=512, densify_from_iter=10_000)
    jt = JTrainer(jconfig, width=32, height=32, backend="pallas_interpret")
    s0 = jt.init_state(j_init(pts, colors, jconfig), spatial_lr_scale=0.5)
    s1, m1 = jt.train_step(s0, jcams[1], jnp.asarray(gts[1]))

    tt = GSTrainer(TrainConfig(capacity=512, densify_from_iter=10_000), width=32, height=32, device="cpu")
    t0 = train_state_from_numpy(j_state_to_numpy(s0), device="cpu")
    t1, m2 = tt.train_step(t0, tcams[1], torch.tensor(gts[1]))

    assert np.isclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    want = j_state_to_numpy(s1)
    assert_state_close(t1, want, rtol=1e-3, atol=2e-5)
    for g in GROUPS:
        np.testing.assert_allclose(t1.mu[g].numpy(), want["mu"][g], rtol=1e-3, atol=2e-5, err_msg=g)
    np.testing.assert_allclose(t1.xyz_grad_accum.numpy(), want["xyz_grad_accum"], rtol=5e-2, atol=1e-7)
    np.testing.assert_array_equal(t1.denom.numpy(), want["denom"])
    assert (t1.count, t1.step) == (want["count"]["xyz"], want["step"]) == (1, 1)


def test_abs_grad_statistic_dominates_signed(setup):
    """(i) the trainer's AbsGS path: the |per-tile| statistic dominates the
    signed one, exceeds it somewhere, keeps its visibility, and leaves the
    parameter step unchanged."""
    _, tcams, gts, pts, colors = setup
    config = TrainConfig(capacity=512)
    s0 = GSTrainer(config, width=32, height=32, device="cpu").init_state(
        init_from_points(pts, colors, config, device="cpu"), spatial_lr_scale=0.5)
    gt = torch.tensor(gts[0])
    s_sig, m_sig = GSTrainer(config, width=32, height=32, device="cpu").train_step(s0, tcams[0], gt)
    abs_cfg = TrainConfig(capacity=512, densify_abs_grad=True)
    s_abs, m_abs = GSTrainer(abs_cfg, width=32, height=32, device="cpu").train_step(s0, tcams[0], gt)
    assert float(m_sig["loss"]) == float(m_abs["loss"])
    torch.testing.assert_close(s_sig.cloud.xyz, s_abs.cloud.xyz, rtol=1e-5, atol=1e-7)
    g_sig, g_abs = s_sig.xyz_grad_accum.numpy(), s_abs.xyz_grad_accum.numpy()
    assert np.all(g_abs >= g_sig * (1 - 1e-4) - 1e-12)
    assert np.any(g_abs > g_sig * 1.01)  # cancellation across tiles
    np.testing.assert_array_equal(g_abs > 0, g_sig > 0)


def test_densify_and_prune_matches_reference(setup):
    """(h) densify_and_prune from one JAX mid-training state, fed JAX's two
    noise draws: every field, the moments and the alive mask to 1e-6."""
    *_, pts, colors = setup
    jconfig = JConfig(capacity=512, max_split_per_round=128, densify_grad_threshold=2e-4)
    jt = JTrainer(jconfig, width=32, height=32, backend="tiled")
    s = jt.init_state(j_init(pts, colors, jconfig), spatial_lr_scale=0.5)
    rng = np.random.default_rng(6)
    cap = 512
    f32 = lambda *shape: jnp.asarray(rng.normal(size=shape), jnp.float32)
    opt = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype) if x.ndim else x + 7, s.opt_state
    )
    cloud = s.cloud.replace(
        scale=s.cloud.scale + f32(cap, 3) * 0.5,  # both clones and splits
        opacity=s.cloud.opacity + f32(cap, 1) * 1.5,  # some prunes
        rot=s.cloud.rot + f32(cap, 4) * 0.3,
    )
    s = s.replace(
        cloud=cloud, opt_state=opt, step=jnp.asarray(700, jnp.int32),
        xyz_grad_accum=jnp.abs(f32(cap)) * 6e-4, denom=jnp.asarray(rng.integers(0, 4, cap), jnp.float32),
    )
    key = jax.random.PRNGKey(3)
    extent = 1.0
    want = j_state_to_numpy(jt.densify_and_prune(s, key, extent))
    noise = torch.tensor(np.asarray(jax.random.normal(key, (128, 3))))
    noise2 = torch.tensor(np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (cap, 3))))

    tt = GSTrainer(TrainConfig(capacity=512, max_split_per_round=128), width=32, height=32, device="cpu")
    before = j_state_to_numpy(s)
    got = tt.densify_with_noise(train_state_from_numpy(before, device="cpu"), noise, noise2, extent)

    alive0, alive1 = before["cloud"]["alive"], want["cloud"]["alive"]
    pruned = alive0 & (before["cloud"]["opacity"][:, 0] < np.log(0.005 / 0.995))
    assert alive1.sum() > alive0.sum() and pruned.any()  # grew, and freed slots
    np.testing.assert_array_equal(got.cloud.alive.numpy(), alive1)
    assert_state_close(got, want, rtol=1e-6, atol=1e-6, fields=CLOUD_TENSORS)
    for g in GROUPS:
        np.testing.assert_allclose(got.mu[g].numpy(), want["mu"][g], rtol=1e-6, atol=1e-6, err_msg=g)
        np.testing.assert_allclose(got.nu[g].numpy(), want["nu"][g], rtol=1e-6, atol=1e-6, err_msg=g)
    assert got.count == want["count"]["xyz"] == 7
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        assert not getattr(got, f).any() and not want[f].any()


def test_checkpoint_round_trip(setup, tmp_path):
    """(l) save_checkpoint / restore_checkpoint of a TrainState."""
    _, tcams, gts, pts, colors = setup
    config = TrainConfig(capacity=512)
    trainer = GSTrainer(config, width=32, height=32, device="cpu")
    state = trainer.init_state(init_from_points(pts, colors, config, device="cpu"), 0.5)
    state, _ = trainer.train_step(state, tcams[2], torch.tensor(gts[2]))
    save_checkpoint(state, tmp_path / "ckpt" / "state.pt")
    template = trainer.init_state(init_from_points(pts, colors, config, device="cpu"))
    back = restore_checkpoint(template, tmp_path / "ckpt" / "state.pt")
    for f in CLOUD_FIELDS:
        assert torch.equal(getattr(back.cloud, f), getattr(state.cloud, f)), f
    for g in GROUPS:
        assert torch.equal(back.mu[g], state.mu[g]) and torch.equal(back.nu[g], state.nu[g])
    assert (back.count, back.step, back.spatial_lr_scale) == (1, 1, 0.5)
    assert torch.equal(back.xyz_grad_accum, state.xyz_grad_accum)
    small = GSTrainer(TrainConfig(capacity=256), width=32, height=32, device="cpu").init_state(
        init_from_points(pts, colors, TrainConfig(capacity=256), device="cpu"))
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(small, tmp_path / "ckpt" / "state.pt")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(template, tmp_path / "missing.pt")


# -- the loader's PNG reader ---------------------------------------------------------------


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG whose rows cycle through the given filter types."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * ch).astype(np.int32)
    prev, rows = np.zeros(w * ch, np.int32), []
    for y in range(h):
        f, cur = filters[y % len(filters)], x[y]
        a = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = (0, a, prev, (a + prev) // 2, paeth)[f]
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(19, 23), (19, 23, 3), (19, 23, 4)])
def test_read_png_matches_imageio(tmp_path, shape):
    """(k) read_png against imageio on files from write_png, from imageio
    and with every row filter (None, Sub, Up, Average, Paeth)."""
    rng = np.random.default_rng(len(shape))
    img = (rng.random(shape) * 255).astype(np.uint8)
    smooth = np.add.outer(np.arange(shape[0]), np.arange(shape[1])).astype(np.uint8)
    smooth = smooth if len(shape) == 2 else np.repeat(smooth[..., None], shape[2], axis=2)
    paths = {"write_png": tmp_path / "a.png", "imageio": tmp_path / "b.png",
             "imageio_smooth": tmp_path / "c.png", "filters": tmp_path / "d.png"}
    write_png(paths["write_png"], img)
    imageio.imwrite(paths["imageio"], img)
    imageio.imwrite(paths["imageio_smooth"], smooth)
    paths["filters"].write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4]))
    for name, path in paths.items():
        got, want = read_png(path), imageio.imread(path)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(read_png(paths["filters"]), img)


def test_read_png_rejects_what_it_does_not_decode(tmp_path):
    """16-bit samples decode (the writer's depth PNGs, which the BOP scorer
    reads back); palette PNGs and non-PNG files are refused."""
    depth = (np.random.default_rng(0).random((7, 9)) * 65535).astype(np.uint16)
    write_png(tmp_path / "depth.png", depth)
    imageio.imwrite(tmp_path / "depth_imageio.png", depth)
    for name in ("depth.png", "depth_imageio.png"):
        got = read_png(tmp_path / name)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, depth, err_msg=name)
    palette = bytearray(_png_with_filters(np.zeros((3, 4), np.uint8), [0]))
    palette[25] = 3  # IHDR colour type: palette (the CRC is not checked)
    (tmp_path / "palette.png").write_bytes(bytes(palette))
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(tmp_path / "palette.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")


# -- the wrapper -------------------------------------------------------------------------


def test_wrapper_matches_reference(tmp_path):
    """(j) train_gaussian_splatting_wrapper on tests/test_training_wrapper.py's
    48x48 COLMAP scene (6 views, 75 seed points, capacity 512, 12
    iterations, no densify), port against the JAX wrapper (whose CPU
    backend is its tiled XLA compositor).  Both PLYs hold the same splats;
    every field agrees to atol 1e-4 (measured: 2.2e-5 at most, in rot and
    opacity; 1.5e-8 in xyz, whose learning rate is smallest), and the o3d
    companion PLYs agree to the same atol in xyz and one level in colour."""
    from pegasus_tpu.io import colmap as cio
    from pegasus_tpu.io.png import write_png as j_write_png
    from pegasus_tpu.testing import make_colmap_hemisphere
    from pegasus_tpu.training.trainer import train_gaussian_splatting_wrapper as j_wrapper
    from pegasus_tpu.utils.pose import focal2fov

    from pegasus_tpu_torch.gs.ply import read_ply_vertex_data
    from pegasus_tpu_torch.training.trainer import train_gaussian_splatting_wrapper

    w = h = 48
    focal = 60.0
    cams, images = make_colmap_hemisphere(n_images=6, radius=0.5, width=w, height=h, focal=focal)
    gt_cloud = j_box(np.random.default_rng(0), n=300, half_extents=(0.07, 0.07, 0.09),
                     rgb=(0.6, 0.3, 0.2), object_id=0)
    data = tmp_path / "scene"
    sparse = data / "sparse" / "0"
    sparse.mkdir(parents=True)
    cio.write_cameras_binary(cams, sparse / "cameras.bin")
    cio.write_images_binary(images, sparse / "images.bin")
    pts_xyz = np.asarray(gt_cloud.xyz)[::4]
    cio.write_points3d_binary({
        i: cio.ColmapPoint3D(i, pts_xyz[i], np.array([128, 90, 70], np.uint8), 0.1,
                             np.zeros(0, np.int32), np.zeros(0, np.int32))
        for i in range(len(pts_xyz))
    }, sparse / "points3D.bin")
    (data / "images").mkdir()
    fov = focal2fov(focal, w)
    for im in images.values():
        cam = JCamera.from_colmap(im.qvec, im.tvec, fov, fov, w, h)
        out = j_reference(gt_cloud, cam, max_objects=1, chunk=512)
        j_write_png(data / "images" / im.name, (np.clip(np.asarray(out.rgb), 0, 1) * 255).astype(np.uint8))

    kw = dict(TEST_ITERATION=(12,), SAVE_ITERATION=(12,), iterations=12, capacity=512)
    j_wrapper(str(data), str(tmp_path / "jax"), **kw)
    state = train_gaussian_splatting_wrapper(str(data), str(tmp_path / "torch"), device="cpu", **kw)
    assert state.step == 12 and state.count == 12

    ply = "point_cloud/iteration_12/point_cloud.ply"
    want, got = read_ply_vertex_data(tmp_path / "jax" / ply), read_ply_vertex_data(tmp_path / "torch" / ply)
    assert list(got) == list(want) and len(got["x"]) == len(pts_xyz)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
    o3d = "point_cloud/iteration_12/point_cloud_o3d.ply"
    want, got = read_ply_vertex_data(tmp_path / "jax" / o3d), read_ply_vertex_data(tmp_path / "torch" / o3d)
    assert list(got) == list(want) == ["x", "y", "z", "red", "green", "blue"]
    for name in want:  # colours: one 8-bit level where f_dc sits on a rounding edge
        np.testing.assert_allclose(got[name].astype(np.float64), want[name], atol=1e-4 if name in "xyz" else 1)
