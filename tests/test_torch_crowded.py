"""Port parity, crowded scenes: K > 32 object channels on every path.

PEGASUS renders a scene of n objects with K = n + 1 channels (channel 0 is
the environment), and the JAX package has no bound on K.  These tests hold
the port at K = 33 .. 64 against it, on the CPU, where both compositor
kernels take their plain torch versions:

* ``rasterize`` on a plane and K - 1 small boxes against the reference's
  golden ``rasterize_reference`` and its Pallas ``rasterize_pallas``
  (interpret mode): every ``RenderOutputs`` field and each of the K seg /
  vis / amodal channels > 60 dB, tests/test_torch_render.py's gate (the
  reference's two compositors agree to 3e-7 at K = 40);
  ``rasterize_chunk`` of two views bitwise equal to per-frame calls;
* ``rasterize_diff`` at K = 40 against ``rasterize_pallas_diff(...,
  interpret=True)`` for a seeded cotangent on every channel, at
  tests/test_torch_vjp.py's tolerances (loss rtol 1e-4, cosine > 0.999,
  rtol 2e-2, atol 2e-4); the plain backward against autograd through the
  plain forward at K = 40 and 64, and at K = 49 on a tile of several work
  items (cosine > 0.99999, rtol 1e-3, atol 1e-6 x the row's magnitude);
* the frame byte packing (2K mask bits) and its host decode at K = 49
  bitwise equal to the reference's;
* the splat-sharded render at K = 40 on 2 and 3 CPU lanes against the
  unsharded render, <= 1e-5 per field (tests/test_torch_parallel.py);
* the ``PEGASUS`` lifecycle with 40 objects (K = 41) against the
  reference's, tests/test_torch_pegasus.py's gates, and its gt-info records
  from the masks in memory equal to ``calculate_gt_info``'s read-back.
"""

import json

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.assets.registry import Asset as JAsset
from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.gs.cloud import merge as jmerge
from pegasus_tpu.ops import render as jrender
from pegasus_tpu.ops.pallas_vjp import rasterize_pallas_diff
from pegasus_tpu.ops.rasterize_pallas import rasterize_pallas
from pegasus_tpu.ops.rasterize_ref import RenderOutputs as JRenderOutputs
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.pegasus import PEGASUS as JPEGASUS
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import CameraBatch
from pegasus_tpu_torch.interop import (CAMERA_FIELDS, CLOUD_FIELDS,
                                       camera_from_numpy, cloud_from_numpy)
from pegasus_tpu_torch.io.bop_writer import calculate_gt_info
from pegasus_tpu_torch.ops import render as trender
from pegasus_tpu_torch.ops.binning import bin_splats
from pegasus_tpu_torch.ops.composite_vjp import (N_GRAD, composite_tiles_backward_torch,
                                                 entry_grads_to_splats, rasterize_diff)
from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import (CHUNK_ENTRIES, composite_tiles_torch,
                                                   num_channels, rasterize, rasterize_chunk)
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs
from pegasus_tpu_torch.parallel.mesh import make_mesh
from pegasus_tpu_torch.parallel.sharded_render import rasterize_splat_sharded
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.scene.composition import pose_scene
from pegasus_tpu_torch.testing import build_synthetic_dataset, make_tile_pileup
from test_torch_pegasus import MODALITIES, _psnr_u8, assert_json_close
from test_torch_render import psnr
from test_torch_vjp import PARAMS, cosine

torch.set_num_threads(1)

BG = (0.1, 0.1, 0.1)
OBJECT_FIELDS = ("seg_weights", "vis_weights", "amodal")


def crowd(k, seed=0):
    """A plane (object 0) and K - 1 small boxes (objects 1 .. K - 1) on a
    grid, in the JAX package, with the port's copy of it."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(k - 1)))
    parts = [j_plane(rng, n=400, size=1.0)]
    for i in range(k - 1):
        x, y = (i % side) / (side - 1) - 0.5, (i // side) / (side - 1) - 0.5
        parts.append(j_box(rng, n=30, half_extents=(0.02, 0.02, 0.03),
                           center=(0.35 * x, 0.35 * y, 0.04), object_id=i + 1,
                           rgb=tuple(rng.uniform(0.1, 0.9, 3))))
    jscene = jmerge(parts)
    return jscene, cloud_from_numpy({f: np.asarray(getattr(jscene, f)) for f in CLOUD_FIELDS},
                                    device="cpu")


def camera(width, height, eye=(0.0, -0.35, 0.55)):
    jcam = JCamera.look_at(eye=eye, target=(0, 0, 0.03), up=(0, 0, 1), fovx=np.deg2rad(55),
                           fovy=np.deg2rad(45), width=width, height=height)
    d = {f: np.asarray(getattr(jcam, f)) for f in CAMERA_FIELDS}
    d["width"], d["height"] = width, height
    return jcam, camera_from_numpy(d, device="cpu")


def channel_psnr(ref, out):
    """dB per RenderOutputs field, and per object channel of seg / vis / amodal."""
    report = {}
    for name in RenderOutputs._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        peak = max(float(a.max()), 1e-6) if name == "depth" else 1.0
        report[name] = psnr(a, b, peak)
        if name in OBJECT_FIELDS:
            for k in range(a.shape[-1]):
                report[f"{name}[{k}]"] = psnr(a[..., k], b[..., k])
    return report


@pytest.mark.parametrize("width,height", [(32, 32), (64, 48)])
@pytest.mark.parametrize("k", [33, 40, 64])
def test_rasterize_matches_reference_crowded(k, width, height):
    jscene, tscene = crowd(k)
    jcam, tcam = camera(width, height)
    out = rasterize(tscene, tcam, background=BG, max_objects=k)
    assert out.seg_weights.shape == (height, width, k)
    golden = j_reference(jscene, jcam, background=BG, max_objects=k)
    pallas = rasterize_pallas(jscene, jcam, background=BG, max_objects=k, interpret=True)
    for ref in (golden, pallas):
        db = channel_psnr(ref, out)
        assert min(db.values()) > 60, sorted(db.items(), key=lambda kv: kv[1])[:3]
    # the scene fills the channels: channels 32 .. K - 1 are drawn and seen
    vis = out.vis_weights.numpy().max(axis=(0, 1))
    assert (vis[32:] > 0.5).any() and (vis[1:] > 0.5).sum() >= (k - 1) // 2


def test_rasterize_chunk_crowded_equals_frames():
    k = 49
    _, tscene = crowd(k, seed=1)
    cams = [camera(48, 40)[1], camera(48, 40, eye=(0.3, -0.2, 0.5))[1]]
    chunk = rasterize_chunk(tscene, CameraBatch.stack(cams), background=BG, max_objects=k)
    assert chunk.amodal.shape == (2, 40, 48, k)
    for f, cam in enumerate(cams):
        one = rasterize(tscene, cam, background=BG, max_objects=k)
        assert all(torch.equal(a[f], b) for a, b in zip(chunk, one)), f


def test_grad_parity_vs_jax_crowded():
    """rasterize_diff at K = 40 against the reference's Pallas VJP pair
    (interpret mode), for a seeded cotangent on every output channel."""
    k, w, h = 40, 32, 32
    jscene, tscene = crowd(k, seed=2)
    jcam, tcam = camera(w, h)
    rng = np.random.default_rng(4)
    cot = {name: rng.standard_normal(shape).astype(np.float32)
           for name, shape in (("rgb", (h, w, 3)), ("depth", (h, w)), ("alpha", (h, w)),
                               ("seg_weights", (h, w, k)), ("vis_weights", (h, w, k)),
                               ("amodal", (h, w, k)))}

    def j_loss(params):
        out = rasterize_pallas_diff(jscene.replace(**params), jcam, max_objects=k, chunk=128,
                                    interpret=True)
        return sum(jnp.sum(getattr(out, n) * c) for n, c in cot.items())

    jl, jg = jax.value_and_grad(j_loss)({p: getattr(jscene, p) for p in PARAMS})

    params = {p: getattr(tscene, p).clone().requires_grad_(True) for p in PARAMS}
    out = rasterize_diff(tscene.replace(**params), tcam, max_objects=k)
    tl = sum(torch.sum(getattr(out, n) * torch.from_numpy(c)) for n, c in cot.items())
    tl.backward()

    assert np.isclose(float(tl.detach()), float(jl), rtol=1e-4), (float(tl.detach()), float(jl))
    for p in PARAMS:
        a, b = params[p].grad.numpy(), np.asarray(jg[p])
        assert cosine(a, b) > 0.999, (p, cosine(a, b))
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-4, err_msg=p)


@pytest.mark.parametrize("case,k", [("crowd", 40), ("crowd", 64), ("pileup", 49)])
def test_plain_backward_matches_autograd_crowded(case, k):
    """composite_tiles_backward_torch against autograd through
    composite_tiles_torch, for a seeded cotangent on every channel; the
    pile-up (tile 0 of ~2,000 entries: several work items) on K - 1 object
    ids.  Per parameter row: cosine > 0.99999, rtol 1e-3 and atol 1e-6 x
    max(1, the row's max |gradient|): the one walk forms the suffix sums as
    S - prefix, with S summed over 3K + 7 channels of unit cotangent, so
    the cancellation error scales with the gradients (tests/test_torch_vjp.py's
    atol 1e-6 holds rows of magnitude < 1 at K = 2)."""
    w, h = 48, 40
    if case == "crowd":
        bins = bin_splats(project_gaussians(crowd(k, seed=3)[1], camera(w, h)[1]), w, h)
    else:
        proj = make_tile_pileup(np.random.default_rng(2), {0: 2_000, 1: CHUNK_ENTRIES + 1, 4: 60},
                                w, h, k, device="cpu")
        bins = bin_splats(proj, w, h)
        assert int(bins.tile_count[0]) > 2 * CHUNK_ENTRIES and bins.max_object_id > 32
    g = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (h, w, num_channels(k))).astype(np.float32))
    params = bins.params.clone().requires_grad_(True)
    (composite_tiles_torch(bins._replace(params=params), w, h, k) * g).sum().backward()
    out, partials = composite_tiles_torch(bins, w, h, k, return_partials=True)
    got = entry_grads_to_splats(bins, composite_tiles_backward_torch(bins, g, out, partials,
                                                                     w, h, k))
    assert torch.all(got[N_GRAD:] == 0)
    for r in range(N_GRAD):
        assert cosine(got[r], params.grad[r]) > 0.99999, r
        want = params.grad[r].numpy()
        np.testing.assert_allclose(got[r].numpy(), want, rtol=1e-3,
                                   atol=1e-6 * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"row {r}")


def test_frame_bytes_crowded_identical_to_reference():
    """pack_frame_bytes (2 x 48 mask bits in 12 bytes) and the host decode
    (the tensordot branch of K > 8) at K = 49, bitwise."""
    rng = np.random.default_rng(6)
    h, w, k = 12, 10, 49
    fields = {
        "rgb": rng.uniform(-0.1, 1.1, (h, w, 3)),
        "depth": rng.uniform(0.0, 70.0, (h, w)),
        "alpha": rng.uniform(0, 1, (h, w)),
        "seg_weights": rng.uniform(0, 1, (h, w, k)),
        "vis_weights": np.eye(k)[rng.integers(0, k, (h, w))] * rng.uniform(0.5, 1, (h, w, 1)),
        "amodal": rng.uniform(0, 1, (h, w, k)),
    }
    fields = {n: v.astype(np.float32) for n, v in fields.items()}
    palette = rng.uniform(0, 1, (k - 1, 3)).astype(np.float32)
    jframe = jrender.decode_modalities(JRenderOutputs(**{n: jnp.asarray(v) for n, v in fields.items()}),
                                       palette)
    ref = np.asarray(jrender.pack_frame_bytes(jrender.encode_frame(jframe)))
    tframe = trender.decode_modalities(RenderOutputs(**{n: torch.tensor(v) for n, v in fields.items()}),
                                       torch.tensor(palette))
    got = trender.pack_frame_bytes(trender.encode_frame(tframe)).numpy()
    assert got.shape == ref.shape == (h, w, 5 + 12)  # 2 x 48 object bits
    np.testing.assert_array_equal(got, ref)
    unpacked = trender.unpack_frame_bytes(got, k - 1, palette=palette)
    assert unpacked["mask_visib"][..., 40:].any()
    for name, v in jrender.unpack_frame_bytes(ref, k - 1, palette=palette).items():
        np.testing.assert_array_equal(unpacked[name], v, err_msg=name)


@pytest.mark.parametrize("n_lanes", [2, 3])
def test_splat_sharded_crowded_matches_unsharded(n_lanes):
    k = 40
    _, tscene = crowd(k, seed=5)
    _, tcam = camera(48, 40)
    mesh = make_mesh((n_lanes,), ("splat",), ["cpu"] * n_lanes)
    got = rasterize_splat_sharded(tscene, tcam, mesh, background=BG, max_objects=k)
    want = rasterize(tscene, tcam, background=BG, max_objects=k)
    assert got.vis_weights.shape == (40, 48, k)
    for name in RenderOutputs._fields:
        diff = float((getattr(got, name) - getattr(want, name)).abs().max())
        assert diff <= 1e-5, (name, diff)


# -- the PEGASUS lifecycle with 40 objects ---------------------------------------------

N_OBJECTS = 40
OBJECTS = tuple((f"crowd_{i:02d}", 100 + i) for i in range(N_OBJECTS))


def _assets(root, asset_cls):
    # a drop volume for 40 objects: in a smaller one they spawn deep inside
    # each other and both packages' engines throw them out of the scene
    env = asset_cls(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                    DROP_REGION=(0.3, 0.3), DROP_HEIGHT=(0.3, 1.2))
    return env, [asset_cls(OBJECT_NAME=n, ID=i, dataset_path=str(root)) for n, i in OBJECTS]


def _config(root, out):
    return dict(
        dataset_path=str(root), env_dataset_path=str(root), urdf_asset_folder=str(root / "urdf"),
        render_height=60, render_width=80, num_cameras=2, num_camera_interpolation_steps=2,
        simulation_steps=40, mode="static", camera_trajectory_mode="sequence",
        dataset_base_path=str(out), seed=11, QUIET=True,
    )


def _run(pegasus, physics_file, env_name):
    pegasus.physics_file = physics_file
    pegasus.selected_env_name = env_name
    pegasus.init("crowd", 1)
    pegasus.init_start_position()
    pegasus.generate_dataset(MODALITIES, save_bop=True, save_video=False)
    pegasus.save2bop()
    return pegasus


def test_pegasus_slice_crowded_matches_reference(tmp_path):
    """Static, frame_chunk 3, 80x60, 40 objects dropped by the reference's
    engine: the BOP trees agree (JSON, rgb > 40 dB, depth within 1 mm where
    alpha > 0.5, each mask plane <= 0.5 % of its pixels)."""
    root = build_synthetic_dataset(tmp_path / "assets", object_names=[n for n, _ in OBJECTS],
                                   env_splats=1024, obj_splats=96)
    env, objs = _assets(root, JAsset)
    rec = JPEGASUS(gs_env_list=[env], gs_object_list=objs, **_config(root, tmp_path / "physics"))
    rec.init_bullet([env], objs, "physics", 1, N_OBJECTS, N_OBJECTS, random=False)
    physics_file, env_name = rec.physics_file, rec.selected_env_name
    assert np.abs(np.asarray(rec.trajectory.times_t)).max() < 2.0  # the drop stays in the scene

    ref = _run(JPEGASUS(gs_env_list=[env], gs_object_list=objs, rasterize_fn=j_reference,
                        frame_chunk=3, **_config(root, tmp_path / "ref")), physics_file, env_name)
    env, objs = _assets(root, Asset)
    got = _run(PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", frame_chunk=3,
                       **_config(root, tmp_path / "port")), physics_file, env_name)
    assert len(got.semantic_colors) == N_OBJECTS == len(ref.semantic_colors)

    ref_root, got_root = tmp_path / "ref" / "crowd", tmp_path / "port" / "crowd"
    for rel in ("camera.json", "models/models_info.json",
                "train/000001/scene_camera.json", "train/000001/scene_gt.json"):
        assert_json_close(json.loads((ref_root / rel).read_text()),
                          json.loads((got_root / rel).read_text()), rel)
    gt = json.loads((got_root / "train/000001/scene_gt.json").read_text())
    assert all(len(v) == N_OBJECTS for v in gt.values())

    scene = ref_root / "train" / "000001"
    pngs = sorted(p.relative_to(scene) for p in scene.rglob("*.png"))
    assert pngs == sorted(p.relative_to(got_root / "train" / "000001")
                          for p in (got_root / "train" / "000001").rglob("*.png"))
    n_frames = len(got.viewport_cam_list)
    assert n_frames == 4 and len(pngs) == n_frames * (3 + 2 * N_OBJECTS)

    worst_mask, seen = 0.0, set()
    for i, cam in enumerate(got.viewport_cam_list):
        alpha = rasterize(pose_scene(got.template, *got._body_poses_at(got._initial_step)), cam,
                          max_objects=N_OBJECTS + 1).alpha.numpy()
        for rel in pngs:
            if not rel.name.startswith(f"{i:06d}"):
                continue
            a = imageio.imread(scene / rel)
            b = imageio.imread(got_root / "train" / "000001" / rel)
            kind = rel.parts[0]
            if kind == "rgb":
                assert _psnr_u8(a, b) > 40, rel
            elif kind == "depth":
                diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
                assert diff[alpha > 0.5].max(initial=0) <= 1, rel
            else:  # mask, mask_visib, sem_mask
                differ = (a != b).reshape(a.shape[0], a.shape[1], -1).any(-1).mean()
                worst_mask = max(worst_mask, differ)
                if kind == "mask_visib" and b.any():
                    seen.add(int(rel.stem.split("_")[1]))
    assert worst_mask <= 0.005, worst_mask
    assert max(seen) >= 32, sorted(seen)  # an object past the 32nd channel is visible

    # gt-info from the masks in memory equals the read-back of the written PNGs
    calculate_gt_info(tmp_path / "port", "crowd", [1])
    info = json.loads((got_root / "train/000001/scene_gt_info.json").read_text())
    assert info == got.last_gt_info and len(info) == n_frames
    assert any(r["px_count_visib"] > 0 for r in info["0"][32:])

