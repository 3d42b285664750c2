"""Port parity, the scene loop: engine, ``init_bullet``, ``run_generation``, the CLI and scene variants.

Both packages build their physics engines from the same synthetic assets
and seeds: the params and the start state must be EQUAL (the geometry is the
same numpy code, the start quaternion is normalised to the same bits), the
trajectory JSON must carry the same ``asset_infos`` and the same first
step, and ``init_bullet`` must make the same draws.  ``run_generation`` runs
in both at 64x48 with a drop of 40 steps (the objects are still falling, so
both trajectories agree to rounding) and the two BOP trees are compared as
``test_torch_pegasus.py`` compares them: same object ids, no mask pixel
different, depth within 1 mm, JSON floats within 1e-5.  Scene variants are
held against the reference's stepper and golden compositor fed the port's
start states (PSNR > 40 dB).
"""

import dataclasses
import json
import re
from pathlib import Path

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.assets.registry import Asset as JAsset
from pegasus_tpu.camera import Camera as JCamera
from pegasus_tpu.config import GenerationConfig as JConfig
from pegasus_tpu.generate import run_generation as j_run_generation
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.pegasus import PEGASUS as JPEGASUS
from pegasus_tpu.physics import rigid_body as jrb
from pegasus_tpu.physics.engine import PhysicsEngine as JEngine
from pegasus_tpu.scene.composition import SceneTemplate as JTemplate
from pegasus_tpu.scene.composition import pose_scene as j_pose_scene
from pegasus_tpu.testing import make_box_cloud as j_box
from pegasus_tpu.testing import make_plane_cloud as j_plane
from pegasus_tpu.utils import quaternion as jq

from pegasus_tpu_torch import generate as tgen
from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.eval import check_bop_dataset
from pegasus_tpu_torch.generate import run_generation, write_targets_bop19
from pegasus_tpu_torch.interop import CLOUD_FIELDS, cloud_from_numpy
from pegasus_tpu_torch.parallel.mesh import make_mesh
from pegasus_tpu_torch.parallel.scene_batch import (generate_scene_variants,
                                                    variant_start_states)
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.physics.engine import PhysicsEngine
from pegasus_tpu_torch.scene.composition import SceneTemplate
from pegasus_tpu_torch.testing import build_synthetic_dataset

from test_torch_pegasus import assert_json_close
from test_torch_physics import STATE_FIELDS, both_params, box_params_np, box_points

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OBJECTS = (("cup_noodles_04", 104), ("cup_noodles_07", 107))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("gen_assets")
    build_synthetic_dataset(path, object_names=[n for n, _ in OBJECTS])
    return path


def _assets(root, asset_cls):
    env = asset_cls(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                    DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3))
    return env, [asset_cls(OBJECT_NAME=n, ID=i, dataset_path=str(root)) for n, i in OBJECTS]


def _engines(root, tmp_path, steps):
    """Both packages' engines over the same bodies: the environment, both
    objects and the first object again (a second bullet id of one asset)."""
    engines = []
    for cls, asset_cls, extra in ((JEngine, JAsset, {}), (PhysicsEngine, Asset, {"device": "cpu"})):
        env, objs = _assets(root, asset_cls)
        engine = cls(str(root / "urdf"), str(tmp_path / cls.__module__ / "steps.json"),
                     simulation_steps=steps, seed=5, **extra)
        engine.add_object(env, start_pos=env.START_POSITION_PYBULLET)
        for obj, start in zip(objs + objs[:1], ([0.02, 0.01, 0.22], [-0.04, 0.03, 0.3], [0.0, -0.05, 0.4])):
            engine.add_object(obj, start_pos=start)
        engines.append(engine)
    return engines


def test_engine_build_equals_reference_exactly(root, tmp_path):
    j_engine, t_engine = _engines(root, tmp_path, 5)
    jp, js = j_engine._build()
    tp, ts = t_engine._build()
    for f in dataclasses.fields(tp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if f.name == "num_hull_parts":
            assert a == b
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    for f in STATE_FIELDS:
        assert np.array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy()), f
    assert not np.array_equal(ts.rot[1].numpy(), [1, 0, 0, 0])  # a drawn, normalised orientation
    for a, b in zip(j_engine.heightfield, t_engine.heightfield):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_engine_simulate_writes_the_same_json(root, tmp_path):
    j_engine, t_engine = _engines(root, tmp_path, 6)
    j_traj, t_traj = j_engine.simulate(), t_engine.simulate()
    ref = json.loads(Path(j_engine.trajectory_path).read_text())
    got = json.loads(Path(t_engine.trajectory_path).read_text())
    assert got["asset_infos"] == ref["asset_infos"]
    assert got["asset_infos"]["object"]["cup_noodles_04"]["bullet_id"] == [1, 3]
    assert_json_close(ref["trajectory"], got["trajectory"])
    assert t_traj.times_t.shape == j_traj.times_t.shape == (4, 6, 3)
    np.testing.assert_allclose(t_traj.times_t[:, 0], j_traj.times_t[:, 0], atol=1e-7)  # the first step
    np.testing.assert_allclose(t_traj.times_q[:, 0], j_traj.times_q[:, 0], atol=1e-7)
    frames = t_engine.render_debug_camera(t_traj, every=2, size=32, out_dir=tmp_path / "debug")
    assert frames.shape == (3, 32, 32) and len(list((tmp_path / "debug").glob("*.png"))) == 3
    np.testing.assert_array_equal(frames, j_engine.render_debug_camera(j_traj, every=2, size=32))


def test_simulate_variants_is_seeded_and_batched(root, tmp_path):
    _, engine = _engines(root, tmp_path, 12)
    pos, rot = engine.simulate_variants(3, seed=4)
    again, _ = engine.simulate_variants(3, generator=torch.Generator().manual_seed(4))
    assert pos.shape == (3, 12, 8, 3) and rot.shape == (3, 12, 8, 4)
    assert np.array_equal(pos, again)
    assert not np.array_equal(rot[0, 0, 1], rot[1, 0, 1])  # each variant its own orientation
    assert np.array_equal(pos[:, :, 0], np.zeros((3, 12, 3)))  # the environment stays
    np.testing.assert_allclose(np.linalg.norm(rot[:, :, 1:4], axis=-1), 1.0, atol=1e-5)


def _pegasus_kwargs(root, out, steps=40):
    return dict(
        dataset_path=str(root), env_dataset_path=str(root), urdf_asset_folder=str(root / "urdf"),
        render_height=48, render_width=64, num_cameras=1, num_camera_interpolation_steps=2,
        simulation_steps=steps, mode="static", camera_trajectory_mode="sequence",
        dataset_base_path=str(out), seed=11, QUIET=True,
    )


def test_init_bullet_makes_the_reference_draws(root, tmp_path):
    env, objs = _assets(root, JAsset)
    ref = JPEGASUS(gs_env_list=[env], gs_object_list=objs, **_pegasus_kwargs(root, tmp_path / "ref", 8))
    ref.init_bullet([env], objs, "draws", 1, 1, 2)
    env, objs = _assets(root, Asset)
    got = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu",
                  **_pegasus_kwargs(root, tmp_path / "port", 8))
    got.init_bullet([env], objs, "draws", 1, 1, 2)
    assert got.selected_env_name == ref.selected_env_name == "asphalt"
    assert got.selected_object_ids == ref.selected_object_ids
    assert Path(got.physics_file).name == "000001_simulation_steps.json" and Path(got.physics_file).exists()
    assert got.py_engine.max_bodies == ref.py_engine.max_bodies == 8
    for a, b in zip(ref.py_engine._bodies, got.py_engine._bodies):
        assert a["name"] == b["name"]
        assert np.array_equal(a["start_pos"], b["start_pos"])
        assert np.array_equal(a["start_q_xyzw"], b["start_q_xyzw"])
    np.testing.assert_allclose(got.trajectory.times_t, ref.trajectory.times_t, atol=1e-6)
    # the next draw of either generator is the same: both consumed alike
    assert got.rng.integers(0, 2**31) == ref.rng.integers(0, 2**31)
    # rich scenes size the engine themselves
    got.init_bullet([env], objs, "draws", 2, 1, 2, random=False)
    again = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu",
                    **_pegasus_kwargs(root, tmp_path / "again", 8))
    again.init_bullet([env], objs * 6, "draws", 2, 12, 12, random=False)
    assert again.py_engine.max_bodies == 13 and again.trajectory.num_bodies == 13


def _config(cls, root, out, **over):
    fields = dict(
        dataset_path=str(root), urdf_asset_folder=str(root / "urdf"), dataset_base_path=str(out),
        dataset_name="batch_test", num_scenes=2, min_num_objects=1, max_num_objects=2,
        render_width=64, render_height=48, num_cameras=1, num_camera_interpolation_steps=2,
        simulation_steps=40, camera_trajectory_mode="sequence", save_video=False, seed=7,
    )
    fields.update(over)
    return cls(**fields)


def test_run_generation_matches_reference(root, tmp_path):
    env, objs = _assets(root, JAsset)
    j_config = _config(JConfig, root, tmp_path / "ref")
    j_peg = JPEGASUS(gs_env_list=[env], gs_object_list=objs, rasterize_fn=j_reference,
                     **dict(_pegasus_kwargs(root, tmp_path / "ref"), seed=7))
    ref = j_run_generation(j_config, [env], objs, pegasus=j_peg)

    env, objs = _assets(root, Asset)
    config = _config(GenerationConfig, root, tmp_path / "port")
    stats = run_generation(config, [env], objs, device="cpu")
    assert len(stats.records) == 2 and stats.summary()["mean_frames_per_s"] > 0
    for rec, want in zip(stats.records, ref.records):
        # the port's frames arrive writer-ready: 8 + 2K bytes a pixel, against
        # the reference's bit-packed 5 + ceil(2K/8)
        k = rec["n_objects"]
        assert (rec["readback_bytes"] * (5 + -(-2 * k // 8)) == want["readback_bytes"] * (8 + 2 * k)
                and want["readback_bytes"] > 0 and rec["fetch_stall_s"] >= 0)
        assert rec["writer_ready_frames"] == rec["frames"] and rec["handoff_s"] > 0
        assert {"t_physics", "t_setup", "t_render", "t_finalize"} <= set(rec)
        for key in ("scene_id", "frames", "splats", "n_objects", "env", "object_ids"):
            assert rec[key] == want[key], key

    ds, ref_ds = tmp_path / "port" / "batch_test", tmp_path / "ref" / "batch_test"
    assert len((ds / "generation_stats.jsonl").read_text().splitlines()) == 2
    assert GenerationConfig.load(ref_ds / "generation_config.json").frame_chunk == 8  # a JAX-written config loads
    assert (ds / "generation_config.json").exists() and (ds / "train_ndds").exists()
    worst_mask = 0.0
    for sid in (1, 2):
        scene, ref_scene = ds / "train" / f"{sid:06d}", ref_ds / "train" / f"{sid:06d}"
        for name in ("scene_gt.json", "scene_camera.json", "scene_gt_info.json"):
            assert_json_close(json.loads((ref_scene / name).read_text()),
                              json.loads((scene / name).read_text()), f"{sid}/{name}")
        pngs = sorted(p.relative_to(ref_scene) for p in ref_scene.rglob("*.png"))
        assert pngs and pngs == sorted(p.relative_to(scene) for p in scene.rglob("*.png"))
        for rel in pngs:
            a, b = imageio.imread(ref_scene / rel), imageio.imread(scene / rel)
            if rel.parts[0] == "rgb":
                mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2) / 255.0**2
                assert mse == 0 or 10 * np.log10(1.0 / mse) > 40, rel
            elif rel.parts[0] == "depth":
                visible = np.zeros(a.shape, bool)
                for m in (ref_scene / "mask_visib").glob(f"{rel.stem}_*.png"):
                    visible |= imageio.imread(m) > 0
                diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
                assert diff[visible].max(initial=0) <= 1, rel
            else:  # mask, mask_visib, sem_mask
                worst_mask = max(worst_mask, float((a != b).mean()))
    assert worst_mask == 0.0, worst_mask
    for name in ("camera.json", "models/models_info.json"):
        assert_json_close(json.loads((ref_ds / name).read_text()), json.loads((ds / name).read_text()), name)

    # resume: a second run skips the finished scenes
    assert len(run_generation(config, [env], objs, device="cpu").records) == 0
    write_targets_bop19(tmp_path / "port", "batch_test")
    targets = json.loads((ds / "test_targets_bop19.json").read_text())
    assert targets and {"im_id", "obj_id", "scene_id", "inst_count"} <= set(targets[0])
    report = check_bop_dataset(tmp_path / "port", "batch_test")
    assert report["ok"], report["errors"]


def test_cli_generates_a_dataset(root, tmp_path, monkeypatch):
    config = _config(GenerationConfig, root, tmp_path / "cli", num_scenes=1, dataset_name="cli_run",
                     simulation_steps=20, convert_scenewise_to_imagewise=False)
    config.save(tmp_path / "cfg.json")
    tgen.main(["--config", str(tmp_path / "cfg.json"), "--envs", "Asphalt",
               "--objects", "CupNoodle04", "CupNoodle07", "--device", "cpu"])
    scene = tmp_path / "cli" / "cli_run" / "train" / "000001"
    gt = json.loads((scene / "scene_gt.json").read_text())
    assert len(gt) == 2 and {e["obj_id"] for e in gt["0"]} <= {104, 107}
    assert len(list((scene / "rgb").glob("*.png"))) == 2
    # the default device is the card: without one the CLI raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--config", str(tmp_path / "cfg.json"), "--envs", "Asphalt", "--objects", "CupNoodle04"])


def test_sharded_generation_raises(root, tmp_path, monkeypatch):
    """The sharded path is ported: ``--sharded --device cpu`` writes a scene
    on one CPU lane.  What still raises: a mesh over the cards without a card."""
    config = _config(GenerationConfig, root, tmp_path / "sharded", num_scenes=1, simulation_steps=20,
                     dataset_name="cli_sharded")
    config.save(tmp_path / "cfg.json")
    tgen.main(["--config", str(tmp_path / "cfg.json"), "--sharded", "--device", "cpu",
               "--envs", "Asphalt", "--objects", "CupNoodle04", "CupNoodle07"])
    scene = tmp_path / "sharded" / "cli_sharded" / "train" / "000001"
    assert len(json.loads((scene / "scene_gt.json").read_text())) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--config", str(tmp_path / "cfg.json"), "--sharded"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(axis_names=("scene",))


def test_entry_points_default_to_the_card(root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, objs = _assets(root, Asset)
    config = _config(GenerationConfig, root, tmp_path / "none")
    fields = box_params_np([(0.05, 0.05, 0.08)], [0.2])
    _, tp = both_params(fields)
    cam = Camera.look_at(eye=(0.6, 0.5, 0.7), target=(0, 0, 0.05), up=(0, 0, 1), fovx=1.0, fovy=0.8,
                         width=16, height=16, device="cpu")
    for call in (lambda: run_generation(config, [env], objs),
                 lambda: PhysicsEngine(str(root / "urdf"), str(tmp_path / "x.json")),
                 lambda: generate_scene_variants(None, tp, cam, 2),
                 lambda: variant_start_states(2, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_generate_scene_variants_matches_reference():
    """V = 3 drops of 30 steps (still falling): the port against the
    reference's stepper, pose and golden compositor on the port's start
    states."""
    rng = np.random.default_rng(0)
    half = (0.05, 0.05, 0.08)
    j_env = j_plane(rng, n=512, size=1.5)
    j_objs = [j_box(rng, n=128, object_id=1), j_box(rng, n=128, object_id=2, rgb=(0.2, 0.6, 0.9))]
    j_template = JTemplate.build(j_env, j_objs)
    as_torch = lambda c: cloud_from_numpy({f: np.asarray(getattr(c, f)) for f in CLOUD_FIELDS}, device="cpu")
    template = SceneTemplate.build(as_torch(j_env), [as_torch(o) for o in j_objs])
    jp, tp = both_params(box_params_np([half, half], [0.2, 0.2], points=[box_points(half, False)] * 2))
    view = dict(eye=(0.6, 0.5, 0.7), target=(0, 0, 0.05), up=(0, 0, 1), fovx=np.deg2rad(55),
                fovy=np.deg2rad(45), width=64, height=48)
    n_steps, v_n = 30, 3
    res = generate_scene_variants(template, tp, Camera.look_at(**view, device="cpu"), v_n,
                                  n_steps=n_steps, seed=3, max_objects=4, drop_height=(0.2, 0.3),
                                  device="cpu")
    assert res.rgb.shape == (v_n, 48, 64, 3) and res.seg_weights.shape == (v_n, 48, 64, 4)
    assert res.final_pos.shape == (v_n, 3, 3) and res.final_rot.shape == (v_n, 3, 4)
    assert float((res.rgb[0] - res.rgb[1]).abs().max()) > 0.01  # the drops differ

    starts = variant_start_states(v_n, 3, drop_height=(0.2, 0.3),
                                  generator=torch.Generator().manual_seed(3), device="cpu")
    j_cam = JCamera.look_at(**view)
    for v in range(v_n):
        state = jrb.RigidBodyState(**{f: jnp.asarray(getattr(starts, f)[v].numpy()) for f in STATE_FIELDS})
        _, final = jrb.simulate(jp, state, n_steps=n_steps)
        np.testing.assert_allclose(res.final_pos[v].numpy(), np.asarray(final.pos), atol=1e-5)
        np.testing.assert_allclose(res.final_rot[v].numpy(), np.asarray(final.rot), atol=1e-5)
        body_R = jq.quat_to_rotmat(final.rot).at[0].set(jnp.eye(3))
        ref = j_reference(j_pose_scene(j_template, body_R, final.pos.at[0].set(0.0)), j_cam, max_objects=4)
        for name in ("rgb", "depth", "seg_weights", "vis_weights", "amodal"):
            a, b = np.asarray(getattr(ref, name), np.float64), getattr(res, name)[v].numpy().astype(np.float64)
            peak = max(a.max(), 1e-6) if name == "depth" else 1.0
            mse = np.mean((a - b) ** 2)
            assert mse == 0 or 10 * np.log10(peak**2 / mse) > 40, (v, name)
        assert float(res.seg_weights[v][..., 1:].sum()) > 1.0  # the objects are in view


def test_port_imports_no_jax():
    """No module of the port, nor the smoke script, imports jax, flax or
    the JAX package."""
    pattern = re.compile(r"^\s*(from|import)\s+(jax|flax|optax|orbax|pegasus_tpu)(\.|\s|$)", re.M)
    sources = sorted((REPO / "pegasus_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 40
    for path in sources:
        hit = pattern.search(path.read_text())
        assert hit is None, f"{path.relative_to(REPO)}: {hit.group(0).strip()}"
