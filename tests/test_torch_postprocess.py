"""Port parity: ``ops/postprocess.py`` (depth normals, SSAO) against
``pegasus_tpu``, and the numerics tripwires of ``utils/observability.py``.

The depth map is a render of a plane and a box (the port's ``rasterize`` on
the CPU), handed to both packages as one numpy array.  Tolerance 1e-6
absolute: both sides do the same float32 sums (the Sobel's 3x3 terms, the
SSAO's per-sample clips) in another order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.ops import postprocess as jpost
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import merge
from pegasus_tpu_torch.interop import CLOUD_FIELDS, cloud_from_numpy
from pegasus_tpu_torch.ops import postprocess as tpost
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.utils import observability as obs

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=0)


def _cloud(c):
    return cloud_from_numpy({f: np.asarray(getattr(c, f)) for f in CLOUD_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def rendered():
    rng = np.random.default_rng(5)
    scene = merge([_cloud(j_plane(rng, n=500)), _cloud(j_box(rng, n=300, center=(0, 0, 0.08)))])
    cam = Camera.look_at((0.35, 0.25, 0.45), (0, 0, 0.05), (0, 0, 1), np.deg2rad(55),
                         np.deg2rad(45), 64, 48, device="cpu")
    out = rasterize(scene, cam, max_objects=2)
    return scene, out.rgb.clamp(0, 1).numpy(), out.depth.numpy()


def test_normals_from_depth(rendered):
    _, _, depth = rendered
    assert (depth > 0).mean() > 0.5
    for strength in (1.0, 3.0):
        got = tpost.normals_from_depth(torch.from_numpy(depth), strength=strength).numpy()
        np.testing.assert_allclose(got, jpost.normals_from_depth(jnp.asarray(depth), strength),
                                   **TOL)


def test_ssao_and_apply(rendered):
    _, rgb, depth = rendered
    for kw in ({}, {"radius_px": 5, "n_samples": 12, "strength": 2.0}):
        got = tpost.ssao(torch.from_numpy(depth), **kw).numpy()
        ref = np.asarray(jpost.ssao(jnp.asarray(depth), **kw))
        np.testing.assert_allclose(got, ref, **TOL)
        assert ref.min() < 0.999  # the box occludes the plane somewhere
    got = tpost.apply_ssao(torch.from_numpy(rgb), torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, jpost.apply_ssao(jnp.asarray(rgb), jnp.asarray(depth)), **TOL)
    normals = tpost.normals_from_depth(torch.from_numpy(depth))
    np.testing.assert_allclose(
        tpost.ssao(torch.from_numpy(depth), normals=normals).numpy(),
        jpost.ssao(jnp.asarray(depth), normals=jnp.asarray(normals.numpy())), **TOL)


def test_nan_in_a_cloud_is_caught(rendered):
    scene, _, _ = rendered
    obs.assert_finite(scene, name="scene")
    bad = scene.replace(xyz=scene.xyz.clone())
    bad.xyz[3, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"scene\.xyz: 1 non-finite"):
        obs.assert_finite(bad, name="scene")
    with pytest.raises(FloatingPointError, match=r"\['c'\]\[1\]\.xyz"):
        obs.assert_finite({"c": [scene, bad]})

    moved = obs.checked(lambda c: c.translated([0.0, 0.0, 0.1]))
    assert torch.equal(moved(scene).xyz, scene.xyz + torch.tensor([0.0, 0.0, 0.1]))
    with pytest.raises(FloatingPointError, match="non-finite"):
        moved(bad)


def test_nan_debugging_toggles_anomaly_mode():
    assert not torch.is_anomaly_enabled()
    try:
        obs.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0 - 1).sum().backward()
    finally:
        obs.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_trace_leaves_a_file(tmp_path, rendered):
    scene, _, _ = rendered
    with obs.trace(str(tmp_path / "trace")) as log_dir:
        scene.translated([0.1, 0.0, 0.0])
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(log_dir, files[0])) > 0
