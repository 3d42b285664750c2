"""Port parity, the slice: the README lifecycle minus physics.

``PEGASUS(...) -> init -> init_start_position -> generate_dataset ->
save2bop`` runs in both packages from ONE recorded trajectory JSON (made by
a separate reference ``PEGASUS.init_bullet``), the same assets, seed, config
and ``frame_chunk``, so both consume ``self.rng`` identically.  The reference renders
with its golden ``rasterize_reference``; the port runs on the CPU.  The two
BOP trees must agree: JSON integers equal and floats within 1e-5 relative
(1e-6 absolute for values near zero); rgb PNGs > 40 dB; depth within 1 mm
wherever the rendered alpha > 0.5; each mask plane disagreeing on at most
0.5 % of its pixels.  Also: the committed smoke trajectory, and the
port's refusals (no CUDA, unported options).
"""

import json
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from pegasus_tpu.assets.registry import Asset as JAsset
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.pegasus import PEGASUS as JPEGASUS

from pegasus_tpu_torch import network_gui
from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.scene.composition import pose_scene
from pegasus_tpu_torch.scene.trajectory import Trajectory
from pegasus_tpu_torch.testing import (SMOKE_ENV, SMOKE_OBJECTS,
                                       build_synthetic_dataset)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MODALITIES = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]
OBJECTS = (("cup_noodles_04", 104), ("cup_noodles_07", 107))


def _assets(root, asset_cls):
    env = asset_cls(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                    DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3))
    return env, [asset_cls(OBJECT_NAME=n, ID=i, dataset_path=str(root)) for n, i in OBJECTS]


def _config(root, out, mode, cam_mode, freeze=False):
    return dict(
        dataset_path=str(root), env_dataset_path=str(root), urdf_asset_folder=str(root / "urdf"),
        render_height=60, render_width=80, num_cameras=2, num_camera_interpolation_steps=2,
        simulation_steps=40, mode=mode, camera_trajectory_mode=cam_mode,
        dataset_base_path=str(out), seed=11, QUIET=True, freeze_dynamic_gt_pose=freeze,
    )


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Assets built once, and a trajectory recorded by the reference engine."""
    root = tmp_path_factory.mktemp("assets")
    build_synthetic_dataset(root, object_names=[n for n, _ in OBJECTS])
    env, objs = _assets(root, JAsset)
    rec = JPEGASUS(gs_env_list=[env], gs_object_list=objs,
                   **_config(root, tmp_path_factory.mktemp("physics"), "static", "sequence"))
    rec.init_bullet([env], objs, "physics", 1, 2, 2, random=False)
    return root, rec.physics_file, rec.selected_env_name


def _run(pegasus, physics_file, env_name, name):
    pegasus.physics_file = physics_file
    pegasus.selected_env_name = env_name
    pegasus.init(name, 1)
    pegasus.init_start_position()
    pegasus.generate_dataset(MODALITIES, save_bop=True, save_video=False)
    pegasus.save2bop()
    return pegasus


def assert_json_close(ref, got, where="$"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and ref.keys() == got.keys(), where
        for key in ref:
            assert_json_close(ref[key], got[key], f"{where}.{key}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(ref) == len(got), where
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_json_close(a, b, f"{where}[{i}]")
    elif isinstance(ref, float) or isinstance(got, float):
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-6), where
    else:
        assert got == ref, where


def _psnr_u8(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2) / 255.0**2
    return 10 * np.log10(1.0 / mse) if mse > 0 else np.inf


@pytest.mark.parametrize("frame_chunk", [1, 3])
@pytest.mark.parametrize("mode,cam_mode,freeze", [
    ("static", "sequence", False), ("dynamic", "random", False),
    ("static", "random+zoom", False), ("dynamic", "random", True),
])
def test_slice_matches_reference(recorded, tmp_path, mode, cam_mode, freeze, frame_chunk):
    root, physics_file, env_name = recorded
    env, objs = _assets(root, JAsset)
    ref = _run(JPEGASUS(gs_env_list=[env], gs_object_list=objs, rasterize_fn=j_reference,
                        frame_chunk=frame_chunk, **_config(root, tmp_path / "ref", mode, cam_mode, freeze)),
               physics_file, env_name, "slice")
    env, objs = _assets(root, Asset)
    got = _run(PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", frame_chunk=frame_chunk,
                       **_config(root, tmp_path / "port", mode, cam_mode, freeze)),
               physics_file, env_name, "slice")
    assert set(got.last_render_stats) == {"readback_bytes", "fetch_stall_s", "writer_ready_frames",
                                          "handoff_s", "slot_wait_s"}
    assert got.last_render_stats["writer_ready_frames"] == len(got.viewport_cam_list)
    # the reference pads its tail chunk to a full one and reads the padding
    # back; the port's tail chunk is just shorter, and arrives writer-ready:
    # 8 + 2K bytes a pixel against the reference's bit-packed 5 + ceil(2K/8)
    n_chunks = -(-len(got.viewport_cam_list) // frame_chunk)
    k = len(OBJECTS)
    assert (got.last_render_stats["readback_bytes"] * n_chunks * frame_chunk * (5 + -(-2 * k // 8))
            == ref.last_render_stats["readback_bytes"] * len(got.viewport_cam_list) * (8 + 2 * k))
    assert not list((tmp_path / "port").rglob("*.mp4"))  # save_video=False builds no streams

    ref_root, got_root = tmp_path / "ref" / "slice", tmp_path / "port" / "slice"
    for rel in ("camera.json", "models/models_info.json",
                "train/000001/scene_camera.json", "train/000001/scene_gt.json"):
        assert_json_close(json.loads((ref_root / rel).read_text()),
                          json.loads((got_root / rel).read_text()), rel)

    scene = ref_root / "train" / "000001"
    pngs = sorted(p.relative_to(scene) for p in scene.rglob("*.png"))
    assert pngs == sorted(p.relative_to(got_root / "train" / "000001")
                          for p in (got_root / "train" / "000001").rglob("*.png"))
    n_frames = len(got.viewport_cam_list)
    assert n_frames == 4 and len(pngs) == n_frames * (3 + 2 * len(OBJECTS))

    worst_mask = 0.0
    for i, cam in enumerate(got.viewport_cam_list):
        step = got._initial_step + (i if mode == "dynamic" else 0)
        alpha = rasterize(pose_scene(got.template, *got._body_poses_at(step)), cam,
                          max_objects=len(OBJECTS) + 1).alpha.numpy()
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
    # measured on the CPU: 0 disagreeing mask / sem pixels in every mode,
    # rgb >= 86.7 dB, depth off by <= 1 mm, JSON floats within 0.2x their
    # tolerance (scene_gt cam_R_m2c in dynamic mode)
    assert worst_mask <= 0.005, worst_mask


def test_smoke_trajectory_fixture_loads():
    traj = Trajectory.from_json(REPO / "tests" / "data" / "torch_smoke_trajectory.json")
    assert traj.environment.name == SMOKE_ENV[0]
    assert {n: a.object_ID for n, a in traj.objects.items()} == dict(SMOKE_OBJECTS)
    assert traj.num_steps == 310 and traj.num_bodies == 1 + len(SMOKE_OBJECTS)
    assert sorted(traj.object_bullet_ids()) == list(range(1, 1 + len(SMOKE_OBJECTS)))
    assert np.isfinite(traj.times_t).all() and np.isfinite(traj.times_q).all()


def test_smoke_assets_match_the_trajectory(tmp_path):
    traj = Trajectory.from_json(REPO / "tests" / "data" / "torch_smoke_trajectory.json")
    root = build_synthetic_dataset(tmp_path, env_name=traj.environment.name,
                                   object_names=list(traj.objects), env_splats=64, obj_splats=32)
    for name in traj.objects:
        asset = Asset(OBJECT_NAME=name, ID=0, dataset_path=str(root))
        assert Path(asset.gaussian_point_cloud_path()).exists() and Path(asset.urdf_obj_path).exists()


def test_refusals(recorded, tmp_path, monkeypatch):
    root, _, _ = recorded
    env, objs = _assets(root, Asset)
    cfg = _config(root, tmp_path, "static", "sequence")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PEGASUS(gs_env_list=[env], gs_object_list=objs, **cfg)  # default device="cuda"
    # publish2gui is ported (tests/test_torch_gui.py): it constructs and listens
    monkeypatch.setattr(PEGASUS, "PORT", 0)
    try:
        assert PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", **cfg,
                       publish2gui=True).publish2gui
        assert network_gui.listener is not None
    finally:
        network_gui.close()
    # compact_readback is ported (tests/test_torch_readback.py): it constructs
    assert PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", **cfg,
                   compact_readback=True).compact_readback
    # physics is ported: the engine init_bullet builds takes the PEGASUS's
    # device, so with the default device and no card it is the constructor
    # above that refuses, and on the CPU a drop runs
    monkeypatch.undo()
    pegasus = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", **dict(cfg, simulation_steps=4))
    pegasus.init_bullet([env], objs, "x", 1)
    assert pegasus.py_engine.device.type == "cpu" and pegasus.trajectory.num_steps == 4


def test_reference_constructor_keywords(recorded, tmp_path):
    """The reference's ``frame_chunk`` is taken (frames per set of launches
    and per readback: ``tests/test_torch_chunk.py``) and so is its
    ``rasterize_fn``: a given function is the one that renders every frame
    (``tests/test_torch_tiled.py`` holds ``rasterize_tiled`` against the
    reference's), with the port's ``rasterize_kwargs`` passed on."""
    root, physics_file, env_name = recorded
    env, objs = _assets(root, Asset)
    cfg = _config(root, tmp_path, "static", "sequence")
    assert PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", **cfg, frame_chunk=8,
                   rasterize_fn=None).frame_chunk == 8
    calls = []

    def white(cloud, cam, background, max_objects, **kwargs):
        calls.append(kwargs)
        out = rasterize(cloud, cam, background=background, max_objects=max_objects)
        return out._replace(rgb=torch.ones_like(out.rgb))

    pegasus = _run(PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", **cfg,
                           frame_chunk=3, rasterize_fn=white, rasterize_kwargs={"tag": 1}),
                   physics_file, env_name, "given")
    assert pegasus.rasterize_fn is white
    n_frames = len(pegasus.viewport_cam_list)
    assert calls == [{"tag": 1}] * n_frames
    rgbs = sorted((tmp_path / "given" / "train" / "000001" / "rgb").glob("*.png"))
    assert len(rgbs) == n_frames and all((imageio.imread(p) == 255).all() for p in rgbs)


def test_video_streams_when_asked(recorded, tmp_path):
    root, physics_file, env_name = recorded
    env, objs = _assets(root, Asset)
    cfg = _config(root, tmp_path, "dynamic", "sequence")
    cfg.update(num_cameras=1)
    pegasus = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", **cfg)
    pegasus.physics_file, pegasus.selected_env_name = physics_file, env_name
    pegasus.init("video", 1)
    pegasus.init_start_position()
    pegasus.generate_dataset(MODALITIES, save_bop=False, save_video=True)
    pegasus.save2bop()
    assert len(list((tmp_path / "video" / "video").rglob("*.mp4"))) == 5


def test_splat_budget_pads_with_dead_splats(recorded, tmp_path):
    root, physics_file, env_name = recorded
    env, objs = _assets(root, Asset)
    cfg = _config(root, tmp_path, "static", "sequence")
    plain = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", **cfg)
    padded = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", splat_budget=6000, **cfg)
    outs = []
    for pegasus in (plain, padded):
        pegasus.physics_file, pegasus.selected_env_name = physics_file, env_name
        pegasus.init("budget", 1)
        pegasus.init_start_position()
        scene = pose_scene(pegasus.template, *pegasus._body_poses_at(pegasus._initial_step))
        outs.append(rasterize(scene, pegasus.viewport_cam_list[0], max_objects=3))
        pegasus.pegasus_dataset.close()
    assert padded.template.cloud.num_splats == 6000
    assert not padded.template.cloud.alive[plain.template.cloud.num_splats:].any()
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
