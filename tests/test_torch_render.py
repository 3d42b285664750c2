"""Port parity, rendering: golden compositor, exact binning, the tile
compositor's plain version, ``rasterize`` and the frame byte packing of
``pegasus_tpu_torch`` against ``pegasus_tpu``'s golden ``rasterize_reference``.

The port runs on the CPU, where ``composite_tiles`` takes its plain torch
version.  Gates: > 60 dB per channel for the golden port (same algorithm),
> 40 dB per channel for ``rasterize`` (the BASELINE gate), which measures
> 60 dB at these sizes and is held to that too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.cloud import merge as jmerge
from pegasus_tpu.ops import render as jrender
from pegasus_tpu.ops.rasterize_ref import RenderOutputs as JRenderOutputs
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane

from pegasus_tpu_torch.interop import (CAMERA_FIELDS, CLOUD_FIELDS,
                                       camera_from_numpy, cloud_from_numpy)
from pegasus_tpu_torch.ops import render as trender
from pegasus_tpu_torch.ops.binning import bin_splats, tile_bboxes
from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                                   composite_tiles_torch,
                                                   rasterize)
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs, rasterize_reference

torch.set_num_threads(1)

BG = (0.1, 0.1, 0.1)
K = 4  # env + objects 1..2, one spare channel


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak**2 / mse) if mse > 0 else np.inf


def channel_psnr(ref, out):
    report = {}
    for name in RenderOutputs._fields:
        a = np.asarray(getattr(ref, name))
        peak = max(float(a.max()), 1e-6) if name == "depth" else 1.0
        report[name] = psnr(a, getattr(out, name).numpy(), peak)
    return report


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    jscene = jmerge([
        j_plane(rng, n=600, size=1.0),
        j_box(rng, n=200, center=(0.0, 0.0, 0.08), object_id=1),
        j_box(rng, n=200, center=(0.12, -0.1, 0.06), object_id=2),
    ])
    return jscene, cloud_from_numpy({f: np.asarray(getattr(jscene, f)) for f in CLOUD_FIELDS}, device="cpu")


def camera(view, width=56, height=44):
    """'objects': looks at the boxes; 'env': plane only, boxes behind."""
    eye, target = {
        "objects": ((0.4, 0.3, 0.5), (0.0, 0.0, 0.05)),
        "env": ((-0.2, -0.2, 0.35), (-0.45, -0.45, 0.0)),
    }[view]
    jcam = JCamera.look_at(eye=eye, target=target, up=(0, 0, 1), fovx=np.deg2rad(55),
                           fovy=np.deg2rad(45), width=width, height=height)
    d = {f: np.asarray(getattr(jcam, f)) for f in CAMERA_FIELDS}
    d["width"], d["height"] = width, height
    return jcam, camera_from_numpy(d, device="cpu")


@pytest.mark.parametrize("view", ["objects", "env"])
def test_golden_compositor_matches_reference(scene, view):
    jscene, tscene = scene
    jcam, tcam = camera(view)
    ref = j_reference(jscene, jcam, background=BG, max_objects=K)
    db = channel_psnr(ref, rasterize_reference(tscene, tcam, background=BG, max_objects=K))
    assert min(db.values()) > 60, db


@pytest.mark.parametrize("view", ["objects", "env"])
def test_rasterize_matches_reference_golden(scene, view):
    jscene, tscene = scene
    jcam, tcam = camera(view)
    ref = j_reference(jscene, jcam, background=BG, max_objects=K)
    out = rasterize(tscene, tcam, background=BG, max_objects=K)
    db = channel_psnr(ref, out)
    assert min(db.values()) > 40, db  # the BASELINE gate
    assert min(db.values()) > 60, db  # measured >= 138 dB at this size
    seg = np.asarray(ref.seg_weights)
    if view == "env":  # no object pixel: the object channels stay empty
        assert seg[..., 1:].max() == 0 and out.seg_weights[..., 1:].abs().max() == 0
    else:
        assert seg[..., 1:].max() > 0.9


def test_exact_binning_is_complete_and_depth_ordered(scene):
    _, tscene = scene
    _, tcam = camera("objects", width=70, height=50)  # ragged edge tiles
    proj = project_gaussians(tscene, tcam)
    bins = bin_splats(proj, tcam.width, tcam.height)
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    assert (ntx, nty) == (5, 4)

    # brute force: tile (tx, ty) holds splat s iff s is on screen and the
    # tile lies in its clipped 3-sigma tile bbox
    mx, my, r = (getattr(proj, f).numpy().astype(np.float64) for f in ("mean_x", "mean_y", "radius"))
    valid = proj.valid.numpy()
    onscreen = valid & (mx + r >= 0) & (mx - r < tcam.width) & (my + r >= 0) & (my - r < tcam.height)
    fl = lambda v, n: np.clip(np.floor(v.astype(np.float32) / np.float32(16)), 0, n - 1)
    x0, x1 = fl(mx - r, ntx), fl(mx + r, ntx)
    y0, y1 = fl(my - r, nty), fl(my + r, nty)
    areas = np.where(onscreen, (x1 - x0 + 1) * (y1 - y0 + 1), 0)
    assert bins.entry_splat.numel() == int(areas.sum()) == int(tile_bboxes(proj, tcam.width, tcam.height)[3].sum())
    assert bins.max_object_id == 2

    depth = proj.depth.numpy()
    starts, counts = bins.tile_start.numpy(), bins.tile_count.numpy()
    entries = bins.entry_splat.numpy()
    assert starts[0] == 0 and (starts[1:] == starts[:-1] + counts[:-1]).all()
    for ty in range(nty):
        for tx in range(ntx):
            tile = ty * ntx + tx
            seg = entries[starts[tile] : starts[tile] + counts[tile]]
            want = np.nonzero(onscreen & (x0 <= tx) & (tx <= x1) & (y0 <= ty) & (ty <= y1))[0]
            assert sorted(seg.tolist()) == want.tolist(), (tx, ty)
            assert (np.diff(depth[seg]) >= 0).all(), (tx, ty)


def test_composite_tiles_cpu_is_the_plain_version(scene):
    _, tscene = scene
    _, tcam = camera("objects")
    bins = bin_splats(project_gaussians(tscene, tcam), tcam.width, tcam.height)
    a = composite_tiles(bins, tcam.width, tcam.height, K)
    b = composite_tiles_torch(bins, tcam.width, tcam.height, K, chunk=16)  # other chunking
    assert a.shape == (tcam.height, tcam.width, 5 + 3 * K + 2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="max_objects"):
        composite_tiles(bins, tcam.width, tcam.height, 2)  # object id 2 needs K >= 3
    with pytest.raises(ValueError, match="tiles"):
        composite_tiles(bins, tcam.width + 16, tcam.height, K)


def test_pack_frame_bytes_identical_to_reference():
    rng = np.random.default_rng(3)
    h, w, k = 12, 10, 4
    fields = {
        "rgb": rng.uniform(-0.1, 1.1, (h, w, 3)),
        "depth": rng.uniform(0.0, 70.0, (h, w)),
        "alpha": rng.uniform(0, 1, (h, w)),
        "seg_weights": rng.uniform(0, 1, (h, w, k)),
        "vis_weights": rng.uniform(0, 1, (h, w, k)),
        "amodal": rng.uniform(0, 1, (h, w, k)),
    }
    fields = {n: v.astype(np.float32) for n, v in fields.items()}
    palette = rng.uniform(0, 1, (k - 1, 3)).astype(np.float32)

    jframe = jrender.decode_modalities(JRenderOutputs(**{n: jnp.asarray(v) for n, v in fields.items()}), palette)
    ref = np.asarray(jrender.pack_frame_bytes(jrender.encode_frame(jframe)))
    tframe = trender.decode_modalities(
        RenderOutputs(**{n: torch.tensor(v) for n, v in fields.items()}), torch.tensor(palette)
    )
    got = trender.pack_frame_bytes(trender.encode_frame(tframe)).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(tframe.seg_image.numpy(), np.asarray(jframe.seg_image), atol=1e-6)

    unpacked = trender.unpack_frame_bytes(got, k - 1, palette=palette)
    for name, v in jrender.unpack_frame_bytes(ref, k - 1, palette=palette).items():
        np.testing.assert_array_equal(unpacked[name], v, err_msg=name)
