"""Port parity, the periphery of the core types: the quaternion, SH, camera
and cloud helpers, the ``GaussianModel`` and ``PegasusSetup`` facades and
the reference-signature render wrappers of ``pegasus_tpu_torch`` against
``pegasus_tpu``.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU.  Tolerances: 1e-6 (absolute and relative) for the
quaternion, SH, camera and cloud operations and the ``GaussianModel``
facade, which do the same float32 arithmetic in another order; 1e-5 for
``PegasusSetup``'s posed clouds (a chain of up to four transforms) and for
renders of a ``transformed`` cloud against the posed scene (two routes to
the same splats, then one compositor); for the render wrappers, RGB and
depth >= 40 dB against the
JAX package's golden compositor and each mask plane disagreeing on at most
0.5 % of its pixels (BASELINE's gates for the port).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pegasus_tpu.assets.registry import Asset as JAsset
from pegasus_tpu.assets.registry import AssetRegistry as JRegistry
from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.camera import stack_cameras as j_stack_cameras
from pegasus_tpu.gs.cloud import merge as jmerge
from pegasus_tpu.gs.model import GaussianModel as JModel
from pegasus_tpu.gs.ply import save_gs_ply as j_save_ply
from pegasus_tpu.ops import render as jrender
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.scene.setup import PegasusSetup as JSetup
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane
from pegasus_tpu.testing import make_random_cloud as j_random
from pegasus_tpu.utils import quaternion as jq
from pegasus_tpu.utils import sh as jsh

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.assets.registry import AssetRegistry as Registry
from pegasus_tpu_torch.camera import Camera, stack_cameras
from pegasus_tpu_torch.gs.model import GaussianModel
from pegasus_tpu_torch.interop import (CAMERA_FIELDS, CLOUD_FIELDS, camera_from_numpy,
                                       cameras_from_numpy, cloud_from_numpy,
                                       gaussian_model_from_numpy)
from pegasus_tpu_torch.ops import render as trender
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.scene.composition import SceneTemplate, pose_scene
from pegasus_tpu_torch.scene.setup import PegasusSetup
from pegasus_tpu_torch.testing import build_synthetic_dataset
from pegasus_tpu_torch.utils import quaternion as tq
from pegasus_tpu_torch.utils import sh as tsh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-6, rtol=1e-6)
CPU = "cpu"


def np_cloud(c) -> dict:
    return {f: np.asarray(getattr(c, f)) for f in CLOUD_FIELDS}


def t_cloud(c):
    return cloud_from_numpy(np_cloud(c), device=CPU)


def t_camera(c):
    return camera_from_numpy({f: np.asarray(getattr(c, f)) for f in CAMERA_FIELDS}, device=CPU)


def assert_clouds_close(jc, tc, **tol):
    for f in CLOUD_FIELDS:
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   err_msg=f, **(tol or TOL))


def look_at(cls, w, h, **kw):
    return cls.look_at(eye=(0.45, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
                       fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=w, height=h, **kw)


# -- quaternion, SH, camera ---------------------------------------------------------------


def test_quaternion_additions(rng):
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    alpha = rng.uniform(size=16).astype(np.float32)
    near = (q + 1e-4 * rng.normal(size=q.shape)).astype(np.float32)  # the lerp branch
    t = torch.from_numpy
    np.testing.assert_allclose(tq.quat_conjugate(t(q)).numpy(), jq.quat_conjugate(q), **TOL)
    np.testing.assert_allclose(tq.quat_rotate(t(q), t(v)).numpy(), jq.quat_rotate(q, v), **TOL)
    for other in (q2, near):
        np.testing.assert_allclose(tq.slerp(t(q), t(other), t(alpha)).numpy(),
                                   jq.slerp(q, other, alpha), **TOL)
    draw = tq.random_unnormalized_quat_xyzw(torch.Generator().manual_seed(0), (8, 4))
    assert draw.shape == (8, 4) and 0.0 <= float(draw.min()) and float(draw.max()) < 1.0
    again = tq.random_unnormalized_quat_xyzw(torch.Generator().manual_seed(0), (8, 4))
    assert torch.equal(draw, again)


def test_rotate_sh_rest(rng):
    f_rest = rng.normal(size=(40, 15, 3)).astype(np.float32)
    R = Rotation.random(random_state=3).as_matrix().astype(np.float32)
    got = tsh.rotate_sh_rest(torch.from_numpy(f_rest), torch.from_numpy(R))
    np.testing.assert_allclose(got.numpy(), jsh.rotate_sh_rest(f_rest, jnp.asarray(R)), **TOL)
    # a degree-1 cloud keeps bands 2-3 untouched
    got1 = tsh.rotate_sh_rest(torch.from_numpy(f_rest), torch.from_numpy(R), deg=1)
    np.testing.assert_allclose(got1.numpy(), jsh.rotate_sh_rest(f_rest, jnp.asarray(R), deg=1),
                               **TOL)


def test_camera_additions(rng):
    jcams = [JCamera.look_at(eye=tuple(rng.uniform(0.3, 1.0, 3)), target=(0, 0, 0), up=(0, 0, 1),
                             fovx=np.deg2rad(50), fovy=np.deg2rad(40), width=40, height=30)
             for _ in range(3)]
    cams = [t_camera(c) for c in jcams]
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    for jc, c in zip(jcams, cams):
        np.testing.assert_allclose(c.world_to_cam(torch.from_numpy(pts)).numpy(),
                                   jc.world_to_cam(jnp.asarray(pts)), **TOL)
        np.testing.assert_allclose(c.T_w2c().numpy(), jc.T_w2c(), **TOL)
    stacked, jstacked = stack_cameras(cams), j_stack_cameras(jcams)
    for f in ("R_w2c", "t_w2c", "fovx", "fovy"):
        np.testing.assert_allclose(stacked[f], np.asarray(getattr(jstacked, f)), **TOL)
    assert (stacked["width"], stacked["height"]) == (40, 30)
    for c, back in zip(cams, cameras_from_numpy(stacked, device=CPU)):
        assert torch.equal(c.R_w2c, back.R_w2c) and torch.equal(c.t_w2c, back.t_w2c)
        assert (c.fovx, c.fovy) == (back.fovx, back.fovy)
    other = Camera.look_at((1, 0, 0), (0, 0, 0), (0, 0, 1), 1.0, 1.0, 20, 30, device=CPU)
    with pytest.raises(ValueError, match="uniform resolution"):
        stack_cameras(cams + [other])
    with pytest.raises(ValueError, match="no cameras"):
        stack_cameras([])


# -- cloud --------------------------------------------------------------------------------


@pytest.mark.parametrize("pivot", ["centroid", "origin", "point"])
def test_cloud_transformed(rng, pivot):
    jc = j_random(rng, n=48, center=(0.3, -0.2, 0.5))
    R = Rotation.random(random_state=7).as_matrix()
    t = np.array([0.1, -0.3, 0.2])
    p = np.array([0.05, 0.1, -0.2]) if pivot == "point" else pivot
    assert_clouds_close(jc.transformed(R, t, pivot=p), t_cloud(jc).transformed(R, t, pivot=p))


def test_cloud_helpers(rng):
    jc = j_random(rng, n=48).masked(np.arange(48) % 5 != 0)
    tc = t_cloud(jc)
    np.testing.assert_allclose(tc.get_rgb().numpy(), jc.get_rgb(), **TOL)
    np.testing.assert_allclose(tc.covariance(0.7).numpy(), jc.covariance(0.7), **TOL)
    t = np.array([0.2, -0.1, 0.05])
    assert_clouds_close(jc.translated(t), tc.translated(t))
    assert_clouds_close(jc.with_flat_color((0.2, 0.9, 0.4)), tc.with_flat_color((0.2, 0.9, 0.4)))
    keep = rng.uniform(size=48) > 0.3
    assert_clouds_close(jc.masked(keep), tc.masked(keep))
    assert_clouds_close(jc.masked(keep), tc.masked(torch.from_numpy(keep)))


def test_transformed_render_equals_posed_scene_render(rng):
    """One object moved by ``transformed`` renders as the same object posed
    by ``pose_scene`` (both rotate about the centroid, premultiply the
    splat quaternions and rotate the SH bands), to 1e-5."""
    env = t_cloud(j_plane(rng, n=300))
    obj = t_cloud(j_box(rng, n=200, center=(0.0, 0.0, 0.08), object_id=1))
    R = Rotation.from_euler("zyx", [0.7, 0.2, -0.3]).as_matrix().astype(np.float32)
    t = np.array([0.05, -0.04, 0.02], np.float32)
    tpl = SceneTemplate.build(env, [obj])
    body_R = torch.stack([torch.eye(3), torch.from_numpy(R)])
    body_t = torch.stack([torch.zeros(3), torch.from_numpy(t)])
    posed = pose_scene(tpl, body_R, body_t)
    moved = trender._compose(env, {1: obj.transformed(R, t)})[0]
    cam = look_at(Camera, 48, 40, device=CPU)
    a, b = rasterize(posed, cam, max_objects=2), rasterize(moved, cam, max_objects=2)
    for name in a._fields:
        np.testing.assert_allclose(getattr(b, name).numpy(), getattr(a, name).numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


# -- GaussianModel --------------------------------------------------------------------------


def test_gaussian_model_facade(tmp_path, rng):
    """The reference test's sequence of facade calls on both packages."""
    path = str(tmp_path / "o.ply")
    j_save_ply(j_box(rng, n=64), path)
    jm, tm = JModel(3).load_ply(path), GaussianModel(3, device=CPU).load_ply(path)
    assert_clouds_close(jm.cloud, tm.cloud)

    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", 0.3).as_matrix()
    T[:3, 3] = [0.1, 0, 0]
    R2 = Rotation.from_euler("x", -0.4).as_matrix()
    for m in (jm, tm):
        m.apply_transformation(T)
        m.apply_rotation_on_xyz(R2)
        m.apply_rotation_on_xyz(R2, origin=True)
        m.apply_translation_on_xyz([0.0, 0.02, -0.01])
        m.apply_transformation_on_xyz(T)
        m.apply_rotation_on_splats(R2)
        m.apply_rotation_on_sh(R2)
    assert_clouds_close(jm.cloud, tm.cloud)
    np.testing.assert_allclose(tm.get_covariance(1.3).numpy(), jm.get_covariance(1.3), **TOL)
    np.testing.assert_allclose(tm.get_opacity.numpy(), jm.get_opacity, **TOL)

    jm.merge_gaussians(JModel(3).load_ply(path))
    tm.merge_gaussians(GaussianModel(3, device=CPU).load_ply(path))
    sel = np.arange(128) % 3 == 0
    for m in (jm, tm):
        m.translate_selected_points(sel, [0.0, 0.0, 0.3])
        m.mask_points(np.arange(128) < 100)
    assert tm.get_xyz.shape == (100, 3)
    assert_clouds_close(jm.cloud, tm.cloud)
    for a, b in zip(tm.get_point_cloud(), jm.get_point_cloud()):
        np.testing.assert_allclose(a, b, **TOL)

    tm2 = gaussian_model_from_numpy(np_cloud(jm.cloud), device=CPU)
    assert_clouds_close(jm.cloud, tm2.cloud)


def test_denoise_point_cloud(rng):
    jc = j_box(rng, n=128)
    jc = jc.replace(xyz=jc.xyz.at[0].set(jnp.array([9.0, 9, 9])))  # an outlier far away
    jm, tm = JModel(3), GaussianModel(3, device=CPU)
    jm.cloud, tm.cloud = jc, t_cloud(jc)
    jm.denoise_point_cloud(nb_points=4, radius=0.1)
    tm.denoise_point_cloud(nb_points=4, radius=0.1)
    assert tm.get_xyz.shape[0] == 127
    assert_clouds_close(jm.cloud, tm.cloud)


# -- PegasusSetup ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    """The committed smoke trajectory's assets (asphalt + six cups), small."""
    from pegasus_tpu_torch.testing import SMOKE_OBJECTS

    root = tmp_path_factory.mktemp("setup")
    build_synthetic_dataset(root, object_names=[n for n, _ in SMOKE_OBJECTS],
                            env_splats=256, obj_splats=64)
    return root


def registry(root, asset_cls):
    from pegasus_tpu_torch.testing import SMOKE_ENV, SMOKE_OBJECTS

    reg_cls = (JRegistry if asset_cls is JAsset else Registry)
    reg = reg_cls()
    reg.add(asset_cls(OBJECT_NAME=SMOKE_ENV[0], ID=SMOKE_ENV[1], TYPE="environment",
                      dataset_path=str(root)))
    for name, i in SMOKE_OBJECTS:
        reg.add(asset_cls(OBJECT_NAME=name, ID=i, dataset_path=str(root)))
    return reg


def test_pegasus_setup_facade(smoke_data):
    """Object loading, the static, dynamic and delta poses, the camera path
    and the centre overlay of both facades from one trajectory JSON."""
    from pegasus_tpu.io import colmap as jcio

    # the recorded assets were plain ``Asset``s: name each by its folder so
    # that the registry resolves them
    d = json.loads((REPO / "tests" / "data" / "torch_smoke_trajectory.json").read_text())
    for group in d["asset_infos"].values():
        for name, info in group.items():
            info["class_name"] = name
    traj = smoke_data / "trajectory.json"
    traj.write_text(json.dumps(d))
    js = JSetup(str(traj), str(smoke_data), 48, 64, asset_registry=registry(smoke_data, JAsset))
    ts = PegasusSetup(str(traj), str(smoke_data), 48, 64, device=CPU,
                      asset_registry=registry(smoke_data, Asset))
    assert ts.environment_class_name == js.environment_class_name
    assert ts.object_data == js.object_data

    jobj, tobj = js.load_object_gs(), ts.load_object_gs()
    assert sorted(tobj) == sorted(jobj)
    js.static_object_pose(jobj)
    ts.static_object_pose(tobj)
    for bid in jobj:
        assert_clouds_close(jobj[bid].cloud, tobj[bid].cloud, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tobj[bid].R_init, jobj[bid].R_init, **TOL)

    jobj, tobj = js.load_object_gs(), ts.load_object_gs()
    js.dynamic_object_pose(jobj)
    ts.dynamic_object_pose(tobj)
    for step in (1, 2, 3):
        js.update_object_pose(jobj, step)
        ts.update_object_pose(tobj, step)
    for bid in jobj:
        assert_clouds_close(jobj[bid].cloud, tobj[bid].cloud, atol=1e-5, rtol=1e-5)

    reco = Path(js.environment.reconstruction_path) / "sparse" / "0"
    for s in (js, ts):
        s.cam_extr = jcio.read_images_binary(reco / "images.bin")
        s.cam_intr = jcio.read_cameras_binary(reco / "cameras.bin")
    jcams = js.create_camera_trajectory(3, 2, mode="random", rng=np.random.default_rng(4))
    tcams = ts.create_camera_trajectory(3, 2, mode="random", rng=np.random.default_rng(4))
    assert len(tcams) == len(jcams)
    for jc, tc in zip(jcams, tcams):
        np.testing.assert_allclose(tc.R_w2c.numpy(), np.asarray(jc.R_w2c), **TOL)
        np.testing.assert_allclose(tc.t_w2c.numpy(), np.asarray(jc.t_w2c), **TOL)

    img = np.zeros((48, 64, 3), np.uint8)
    colors = np.eye(3)[np.arange(len(jobj)) % 3]
    a = js.draw_object_center(img.copy(), jobj, jcams[0], colors, jcams[0].K())
    b = ts.draw_object_center(img.copy(), tobj, tcams[0], colors, tcams[0].K())
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert ts.load_json(traj) == d


# -- render wrappers ------------------------------------------------------------------------


def _psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak**2 / mse) if mse > 0 else np.inf


def test_render_wrappers_against_jax(rng):
    """At 80x60 over a plane and three boxes: RGB and depth >= 40 dB against
    the JAX wrapper (its golden compositor); every mask plane and the
    semantic image disagree on <= 0.5 % of the pixels."""
    from pegasus_tpu.utils.colors import generate_colors

    jenv = j_plane(rng, n=400)
    jobjs = {i + 1: j_box(rng, n=150, center=(0.08 * i - 0.08, 0.03 * i, 0.08), object_id=i + 1)
             for i in range(3)}
    tenv = t_cloud(jenv)
    tobjs = {k: gaussian_model_from_numpy(np_cloud(v), device=CPU) for k, v in jobjs.items()}
    colors = generate_colors(3, mode="rgb")
    jcam, tcam = look_at(JCamera, 80, 60), look_at(Camera, 80, 60, device=CPU)

    jscene = jmerge([jenv] + [c.with_object_id(k) for k, c in jobjs.items()])
    j_rgb, j_depth = jrender.render_rgb_and_depth(jcam, jscene)
    t_rgb, t_depth = trender.render_rgb_and_depth(tcam, t_cloud(jscene))
    assert t_rgb.shape == (60, 80, 3) and t_depth.shape == (60, 80, 1)
    assert _psnr(t_rgb.numpy(), j_rgb) >= 40
    peak = float(np.max(j_depth))
    assert _psnr(t_depth.numpy(), j_depth, peak) >= 40

    def disagree(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        return float(np.mean(a.reshape(-1, a.shape[-1]) != b.reshape(-1, b.shape[-1]), axis=0).max())

    j_vis, j_seg = jrender.render_visib_mask(jcam, jenv, jobjs, colors)
    t_vis, t_seg = trender.render_visib_mask(tcam, tenv, tobjs, colors)
    assert np.asarray(j_vis).any() and disagree(t_vis.numpy(), j_vis) <= 0.005
    assert _psnr(t_seg.numpy(), j_seg) >= 40
    j_sil = jrender.render_silhouette_mask(jcam, jobjs, jenv, color_set=colors)
    t_sil = trender.render_silhouette_mask(tcam, tobjs, tenv, color_set=colors)
    assert disagree(t_sil.numpy(), j_sil) <= 0.005
    assert t_sil.sum() >= t_vis.sum()  # amodal >= visible
    assert disagree(trender.render_silhouette_mask(tcam, tobjs, tenv).numpy(), j_sil) <= 0.005
    j_sem = jrender.render_semanticsegmentation_mask(jcam, jenv, jobjs, colors)
    t_sem = trender.render_semanticsegmentation_mask(tcam, tenv, tobjs, colors)
    assert t_sem.dtype == np.uint8 and t_sem.shape == (60, 80, 3)
    assert disagree(t_sem, j_sem) <= 0.005
    # the golden's own reading of the RGB, as a second yardstick
    golden = j_reference(jscene, jcam)
    assert _psnr(t_rgb.numpy(), np.clip(np.asarray(golden.rgb), 0, 1)) >= 40
