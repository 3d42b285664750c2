"""Port parity, core types: quaternions, SH, camera, cloud, PLY, projection
and pose composition of ``pegasus_tpu_torch`` against ``pegasus_tpu``.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU.  Float32 on both sides, so tolerances are float32
rounding (1e-6 absolute for unit-scale values, 1e-5 for projected columns).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.cloud import merge as jmerge
from pegasus_tpu.ops.projection import project_gaussians as j_project
from pegasus_tpu.scene.composition import SceneTemplate as JTemplate
from pegasus_tpu.scene.composition import pose_scene as j_pose_scene
from pegasus_tpu.scene.composition import poses_from_trajectory_step as j_poses_at
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane
from pegasus_tpu.testing import make_random_cloud as j_random
from pegasus_tpu.utils import quaternion as jq
from pegasus_tpu.utils import sh as jsh

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.ply import load_gs_ply, save_gs_ply
from pegasus_tpu_torch.interop import (CAMERA_FIELDS, CLOUD_FIELDS,
                                       camera_from_numpy, cloud_from_numpy)
from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.scene.composition import (SceneTemplate, pose_scene,
                                                 poses_from_trajectory_step)
from pegasus_tpu_torch.testing import make_random_cloud
from pegasus_tpu_torch.utils import quaternion as tq
from pegasus_tpu_torch.utils import sh as tsh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def to_np(d):
    """Reference object -> dict of numpy arrays (and static ints)."""
    return {
        f: (np.asarray(v) if not isinstance(v, int) else v)
        for f, v in ((f, getattr(d, f)) for f in (CLOUD_FIELDS if hasattr(d, "xyz") else CAMERA_FIELDS))
    }


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def random_quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def test_quaternion_functions_match_reference(rng):
    q = random_quats(rng, 64)
    q2 = random_quats(rng, 64)
    R = Rotation.random(64, random_state=3).as_matrix().astype(np.float32)
    pairs = [
        (jq.normalize(jnp.asarray(q)), tq.normalize(t(q))),
        (jq.quat_to_rotmat(jnp.asarray(q)), tq.quat_to_rotmat(t(q))),
        (jq.rotmat_to_quat(jnp.asarray(R)), tq.rotmat_to_quat(t(R))),
        (jq.quat_mul(jnp.asarray(q), jnp.asarray(q2)), tq.quat_mul(t(q), t(q2))),
        (jq.xyzw_to_wxyz(jnp.asarray(q)), tq.xyzw_to_wxyz(t(q))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_reference(rng, deg):
    sh = rng.normal(size=(32, (deg + 1) ** 2, 3)).astype(np.float32)
    d = rng.normal(size=(32, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ref = jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))
    np.testing.assert_allclose(tsh.eval_sh(deg, t(sh), t(d)).numpy(), np.asarray(ref), atol=1e-6)
    rgb = rng.uniform(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb2sh(t(rgb)).numpy(), np.asarray(jsh.rgb2sh(rgb)), atol=1e-6)
    np.testing.assert_allclose(tsh.sh2rgb(t(rgb)).numpy(), np.asarray(jsh.sh2rgb(rgb)), atol=1e-6)


def test_sh_band_rotation_matches_reference_and_rotates_radiance(rng):
    R = Rotation.random(4, random_state=11).as_matrix().astype(np.float32)
    for band in (1, 2, 3):
        D = tsh.sh_band_rotation(t(R), band).numpy()
        np.testing.assert_allclose(D, np.asarray(jsh.sh_band_rotation(jnp.asarray(R), band)), atol=1e-6)

    # the functional identity of tests/test_sh.py: f_rotated(d) == f(R^T d)
    f = rng.normal(size=(1, 16, 3)).astype(np.float32)
    Rm = R[0]
    rotated = [f[:, :1]]
    start = 1
    for band in (1, 2, 3):
        dim = tsh._BAND_DIMS[band]
        D = tsh.sh_band_rotation(t(Rm), band)
        rotated.append(np.einsum("ij,njc->nic", D.numpy(), f[:, start : start + dim]))
        start += dim
    f_rot = np.concatenate(rotated, axis=1)
    d = rng.normal(size=(50, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    lhs = tsh.eval_sh(3, t(np.broadcast_to(f_rot, (50, 16, 3))), t(d))
    rhs = tsh.eval_sh(3, t(np.broadcast_to(f, (50, 16, 3))), t(d @ Rm))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4)


def test_camera_and_cloud_helpers_match_reference(rng):
    jcam = JCamera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=40, height=32,
    )
    cam = camera_from_numpy(to_np(jcam), device="cpu")
    np.testing.assert_allclose(cam.tan_half_fov(), [float(v) for v in jcam.tan_half_fov()], rtol=1e-6)
    np.testing.assert_allclose(cam.focal_px(), [float(v) for v in jcam.focal_px()], rtol=1e-6)
    for bop in (False, True):
        np.testing.assert_allclose(cam.K(bop).numpy(), np.asarray(jcam.K(bop)), rtol=1e-6)
    np.testing.assert_allclose(cam.camera_center.numpy(), np.asarray(jcam.camera_center), atol=1e-6)
    qvec, tvec = Rotation.random(random_state=4).as_quat()[[3, 0, 1, 2]], rng.normal(size=3)
    jc = JCamera.from_colmap(qvec, tvec, 0.9, 0.7, 64, 48)
    tc = Camera.from_colmap(qvec, tvec, 0.9, 0.7, 64, 48, device="cpu")
    np.testing.assert_allclose(tc.R_w2c.numpy(), np.asarray(jc.R_w2c), atol=1e-7)
    np.testing.assert_allclose(tc.t_w2c.numpy(), np.asarray(jc.t_w2c), atol=1e-7)
    assert (tc.fovx, tc.fovy, tc.width, tc.height) == (float(jc.fovx), float(jc.fovy), 64, 48)

    jcloud = j_random(rng, n=50)
    cloud = cloud_from_numpy(to_np(jcloud), device="cpu")
    assert cloud.num_splats == jcloud.num_splats and cloud.sh_degree == jcloud.sh_degree
    for name in ("get_scaling", "get_opacity", "get_rotation", "get_features", "centroid"):
        np.testing.assert_allclose(
            getattr(cloud, name)().numpy(), np.asarray(getattr(jcloud, name)()), atol=1e-6, err_msg=name
        )
    padded, jpadded = cloud.with_object_id(3).padded(64), jcloud.with_object_id(3).padded(64)
    for f in CLOUD_FIELDS:
        np.testing.assert_array_equal(getattr(padded, f).numpy(), np.asarray(getattr(jpadded, f)), err_msg=f)
    np.testing.assert_array_equal(padded.get_opacity()[50:].numpy(), 0.0)


def test_ply_round_trip(tmp_path, rng):
    cloud = make_random_cloud(rng, n=40, device="cpu")
    path = tmp_path / "pc.ply"
    save_gs_ply(cloud, path)
    back = load_gs_ply(path, device="cpu")
    for f in ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), getattr(cloud, f).numpy(), err_msg=f)


def _scene_and_camera(rng, width=48, height=40):
    jscene = jmerge([
        j_plane(rng, n=400, size=1.0),
        j_box(rng, n=150, center=(0.0, 0.0, 0.08), object_id=1),
        j_box(rng, n=150, center=(0.12, -0.1, 0.06), object_id=2),
    ])
    jcam = JCamera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=width, height=height,
    )
    return jscene, jcam


def test_project_gaussians_matches_reference(rng):
    jscene, jcam = _scene_and_camera(rng)
    ref = j_project(jscene, jcam)
    got = project_gaussians(cloud_from_numpy(to_np(jscene), device="cpu"),
                            camera_from_numpy(to_np(jcam), device="cpu"))
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        if a.dtype == bool or a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=f)


def test_pose_scene_matches_reference(rng):
    env = j_plane(rng, n=100)
    objs = [j_box(rng, n=60, object_id=0), j_random(rng, n=40)]
    jt = JTemplate.build(env, objs, pad_to=256)
    tt = SceneTemplate.build(
        cloud_from_numpy(to_np(env), device="cpu"),
        [cloud_from_numpy(to_np(o), device="cpu") for o in objs], pad_to=256,
    )
    np.testing.assert_allclose(tt.pivots.numpy(), np.asarray(jt.pivots), atol=1e-6)

    times_t = rng.normal(size=(3, 5, 3))
    times_q = rng.normal(size=(3, 5, 4))
    jR, jt_ = j_poses_at(jnp.asarray(times_t, jnp.float32), jnp.asarray(times_q, jnp.float32), 2)
    R, tr = poses_from_trajectory_step(times_t, times_q, 2, device="cpu")
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jt_), atol=1e-6)

    ref = j_pose_scene(jt, jR, jt_)
    got = pose_scene(tt, R, tr)
    for f in ("xyz", "rot", "f_rest"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), atol=1e-5, err_msg=f)
    for f in ("f_dc", "opacity", "scale", "object_id", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)


def test_port_imports_no_jax():
    """The port and every submodule import without jax, flax or pegasus_tpu,
    and importing them flips no global TF32 flag."""
    code = (
        "import torch\n"
        "flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)\n"
        "import importlib, pkgutil, sys\n"
        "import pegasus_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'pegasus_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'pegasus_tpu', 'optax', 'orbax', 'imageio'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 20, names\n"
        "want = {'parallel.mesh', 'parallel.sharded_render', 'parallel.generation', 'parallel.scene_batch',\n"
        "        'ops.validate', 'assets.ycb_objects', 'assets.cup_noodle_dataset', 'assets.dataset_envs',\n"
        "        'assets.in_the_wild_dataset'}\n"
        "assert {'pegasus_tpu_torch.' + w for w in want} <= set(names), names\n"
        "assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
