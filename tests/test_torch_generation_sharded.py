"""Port parity, sharded generation: ``run_generation(mesh=)`` / ``parallel/generation.py``
and the roster rehearsal.

The JAX package's sharded run (``run_generation_sharded`` on 4 of its 8
virtual CPU devices, golden compositor: its CPU default ``rasterize_tiled``
truncates) and the port's (``mesh=`` of 4 CPU lanes) generate
``tests/test_generation_sharded.py``'s dataset from the same synthetic assets
and seed.  Both draw a whole batch's set-ups before they drop it, so the two
datasets hold the same scenes.  Tolerances: the same environment, objects and
object ids per scene; ``scene_gt`` rotations 1e-4 and translations 1e-2 mm;
``scene_camera`` 1e-5 relative; masks differing on at most 0.5 % of the
pixels; depth within 1 mm on 99 % of the pixels; the trajectory JSON's schema
and first step.  Resume, dynamic motion and the sharded tree's schema against
a sequential one's are the port's own; the small rehearsal (3 environments,
6 objects of both rosters, 4 scenes at 48x40, every camera mode) must pass
``check_bop_dataset`` and score AR >= 0.99 with its own poses as estimates.
"""

import json
from pathlib import Path

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from pegasus_tpu.assets.registry import Asset as JAsset
from pegasus_tpu.config import GenerationConfig as JConfig
from pegasus_tpu.io.bop_writer import write_models as j_write_models
from pegasus_tpu.io.mesh import load_mesh as j_load_mesh
from pegasus_tpu.ops.rasterize_ref import rasterize_reference as j_reference
from pegasus_tpu.parallel.generation import run_generation_sharded as j_run_sharded
from pegasus_tpu.parallel.mesh import make_mesh as j_make_mesh

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.assets.rosters import CUP_NOODLE_CLASSES, ENV_CLASSES, YCB_CLASSES
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.eval import check_bop_dataset, score_bop19
from pegasus_tpu_torch.generate import finalize_dataset, run_generation, write_targets_bop19
from pegasus_tpu_torch.parallel.generation import HF_RESOLUTION, _scene_setup
from pegasus_tpu_torch.parallel.mesh import make_mesh
from pegasus_tpu_torch.physics import rigid_body as rb
from pegasus_tpu_torch.testing import (build_roster_dataset, build_synthetic_dataset,
                                       gt_as_estimates_csv)

from test_torch_pegasus import assert_json_close

torch.set_num_threads(1)

OBJECTS = (("cup_noodles_04", 104), ("cup_noodles_07", 107))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_assets")
    build_synthetic_dataset(path, object_names=[n for n, _ in OBJECTS])
    return path


def _assets(root, asset_cls, region=(0.1, 0.1), height=(0.2, 0.3), n_objects=2):
    env = asset_cls(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                    DROP_REGION=region, DROP_HEIGHT=height)
    return env, [asset_cls(OBJECT_NAME=n, ID=i, dataset_path=str(root)) for n, i in OBJECTS[:n_objects]]


def _config(cls, root, out, **over):
    """tests/test_generation_sharded.py:40-59."""
    fields = dict(
        dataset_path=str(root), env_dataset_path=str(root), urdf_asset_folder=str(root / "urdf"),
        dataset_name="sharded_run", dataset_base_path=str(out), num_scenes=4, min_num_objects=1,
        max_num_objects=2, render_width=48, render_height=40, num_cameras=1,
        num_camera_interpolation_steps=2, simulation_steps=20, mode="static",
        camera_trajectory_mode="sequence", seed=12, splat_budget=6000, save_video=False,
    )
    fields.update(over)
    return cls(**fields)


def cpu_lanes(n):
    return make_mesh(devices=["cpu"] * n)


# -- (c) against the JAX package's sharded run ------------------------------------------------


def test_sharded_generation_matches_reference(root, tmp_path):
    env, objs = _assets(root, JAsset)
    ref = j_run_sharded(_config(JConfig, root, tmp_path / "ref"), [env], objs,
                        mesh=j_make_mesh((4,), ("scene",), jax.devices()[:4]),
                        rasterize_fn=j_reference)
    env, objs = _assets(root, Asset)
    drops = []
    real = rb.simulate_batch
    rb.simulate_batch = lambda p, s, **kw: drops.append(s.pos.shape[0]) or real(p, s, **kw)
    try:
        stats = run_generation(_config(GenerationConfig, root, tmp_path / "port"), [env], objs,
                               mesh=cpu_lanes(4))
    finally:
        rb.simulate_batch = real
    assert drops == [4]  # one drop for the whole batch
    assert stats.summary()["scenes"] == 4 and len(stats.records) == len(ref.records) == 4
    for rec, want in zip(stats.records, ref.records):
        for key in ("scene_id", "frames", "n_objects", "env", "object_ids", "binning_overflow_frames"):
            assert rec[key] == want[key], key
        assert set(rec) == set(want)  # the reference's keys, no other
        # the scene's real size, not a budget: the environment and its objects
        assert rec["splats"] == 2048 + 768 * rec["n_objects"] and want["splats"] == 6000
    assert {r["n_objects"] for r in stats.records} == {1, 2}  # the batch mixes object counts
    (batch,) = stats.batches  # the stage seconds of the one batch, beside the records
    assert batch["scene_ids"] == [1, 2, 3, 4]
    assert all(batch[k] > 0 for k in ("t_setup", "t_physics", "t_render"))

    ds, ref_ds = tmp_path / "port" / "sharded_run", tmp_path / "ref" / "sharded_run"
    assert (ds / "generation_config.json").exists()
    assert len((ds / "generation_stats.jsonl").read_text().splitlines()) == 4
    assert_json_close(json.loads((ref_ds / "models" / "models_info.json").read_text()),
                      json.loads((ds / "models" / "models_info.json").read_text()), "models_info")
    worst_mask, depth_share = 0.0, 1.0
    for sid in range(1, 5):
        scene, ref_scene = ds / "train" / f"{sid:06d}", ref_ds / "train" / f"{sid:06d}"
        gt, ref_gt = (json.loads((s / "scene_gt.json").read_text()) for s in (scene, ref_scene))
        assert gt.keys() == ref_gt.keys() == {"0", "1"}
        for fid in gt:
            assert [e["obj_id"] for e in gt[fid]] == [e["obj_id"] for e in ref_gt[fid]]
            for a, b in zip(gt[fid], ref_gt[fid]):
                assert a.keys() == b.keys()
                np.testing.assert_allclose(a["cam_R_m2c"], b["cam_R_m2c"], atol=1e-4)
                np.testing.assert_allclose(a["cam_t_m2c"], b["cam_t_m2c"], atol=1e-2)  # millimetres
        assert_json_close(json.loads((ref_scene / "scene_camera.json").read_text()),
                          json.loads((scene / "scene_camera.json").read_text()), f"{sid}/scene_camera")
        pngs = sorted(p.relative_to(ref_scene) for p in ref_scene.rglob("*.png"))
        assert pngs and pngs == sorted(p.relative_to(scene) for p in scene.rglob("*.png"))
        assert len(list((scene / "mask_visib").glob("000000_*.png"))) == len(gt["0"])  # real objects only
        for rel in pngs:
            a, b = imageio.imread(ref_scene / rel), imageio.imread(scene / rel)
            if rel.parts[0] == "rgb":
                mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2) / 255.0**2
                assert mse == 0 or 10 * np.log10(1.0 / mse) > 40, rel
                assert b.mean() > 5  # content, not black
            elif rel.parts[0] == "depth":
                near = np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1
                depth_share = min(depth_share, float(near.mean()))
            else:  # mask, mask_visib, sem_mask
                worst_mask = max(worst_mask, float((a != b).mean()))
        # the trajectory JSON: the reference's schema, real bodies only, the same first step
        traj, ref_traj = (json.loads((d / "engine" / f"{sid:06d}_simulation_steps.json").read_text())
                          for d in (ds, ref_ds))
        assert traj["asset_infos"] == ref_traj["asset_infos"]
        assert len(traj["trajectory"]) == len(ref_traj["trajectory"]) == 1 + len(gt["0"])
        for body, ref_body in zip(traj["trajectory"].values(), ref_traj["trajectory"].values()):
            assert body.keys() == ref_body.keys()
        assert_json_close(ref_traj["trajectory"], traj["trajectory"], f"{sid}/trajectory")
    assert worst_mask <= 0.005, worst_mask
    assert depth_share >= 0.99, depth_share


def test_scene_setup_draws_and_shapes(root, tmp_path):
    """The set-up makes the reference's draws in its order, sizes every
    scene's physics alike (8 body slots, a 128-cell heightfield) and builds
    the template at its real size, without placeholder bodies."""
    env, objs = _assets(root, Asset)
    config = _config(GenerationConfig, root, tmp_path / "setup", num_cameras=2)
    from pegasus_tpu_torch.gs.ply import load_gs_ply
    from pegasus_tpu_torch.io import colmap as cio

    cpu = torch.device("cpu")
    reco = Path(env.reconstruction_path)
    preload = {"envs": {env.object_name: {
        "gs": {cpu: load_gs_ply(env.gaussian_point_cloud_path(30_000), device="cpu")},
        "cam_extr": cio.read_images_binary(reco / "sparse/0/images.bin"),
        "cam_intr": cio.read_cameras_binary(reco / "sparse/0/cameras.bin")}},
        "objs": {o.object_name: {cpu: load_gs_ply(o.gaussian_point_cloud_path(30_000), device="cpu")}
                 for o in objs}}
    rng, twin = np.random.default_rng(12), np.random.default_rng(12)
    setup = _scene_setup(config, [env], objs, rng, preload, 7, cpu)
    assert twin.integers(0, 1) == 0  # the environment
    n_obj = int(twin.integers(1, 3))
    idx = twin.choice(2, n_obj, replace=False).tolist()
    seed = int(twin.integers(0, 2**31))
    assert setup["n_obj"] == n_obj and [o.ID for o in setup["selected"]] == [objs[i].ID for i in idx]
    engine_rng = np.random.default_rng(seed)  # the engine's own generator draws the orientations
    for body in setup["engine"]._bodies[1:]:
        np.testing.assert_array_equal(body["start_pos"], env.define_start_pos(twin))
        np.testing.assert_array_equal(body["start_q_xyzw"], engine_rng.uniform(0.0, 1.0, size=4))
    assert setup["engine"].max_bodies == 8 and setup["params"].body_mask.tolist() == [True] * (1 + n_obj) + [False] * (7 - n_obj)
    assert setup["heightfield"].grid.shape == (HF_RESOLUTION, HF_RESOLUTION)
    assert setup["template"].num_bodies == 1 + n_obj
    assert setup["template"].cloud.num_splats == 2048 + 768 * n_obj  # splat_budget=6000 is not read
    assert setup["colors"].shape == (2, 3) and (setup["colors"][n_obj:] == 0).all()
    assert len(setup["cams"]) == 4 and setup["engine"].trajectory_path.name == "000007_simulation_steps.json"


# -- resume, dynamic motion, schema ------------------------------------------------------------------


def test_sharded_resume_skips_done_scenes(root, tmp_path):
    env, objs = _assets(root, Asset, region=(0.05, 0.05), height=(0.2, 0.25), n_objects=1)
    base = dict(dataset_name="resume_sh", min_num_objects=1, max_num_objects=1, simulation_steps=15,
                seed=8, splat_budget=4000)
    out = tmp_path / "out"
    mesh = cpu_lanes(2)
    run_generation(_config(GenerationConfig, root, out, num_scenes=2, **base), [env], objs, mesh=mesh)
    s1_gt = out / "resume_sh" / "train" / "000001" / "scene_gt.json"
    mtime_before = s1_gt.stat().st_mtime_ns
    # 3 more scenes on 2 lanes: a full batch and a short last one (no scene repeated)
    stats = run_generation(_config(GenerationConfig, root, out, num_scenes=5, resume=True, **base),
                           [env], objs, mesh=mesh)
    assert [r["scene_id"] for r in stats.records] == [3, 4, 5]
    assert [b["scene_ids"] for b in stats.batches] == [[3, 4], [5]]
    assert s1_gt.stat().st_mtime_ns == mtime_before
    for sid in range(1, 6):
        assert (out / "resume_sh" / "train" / f"{sid:06d}" / "scene_gt.json").exists()
    assert not (out / "resume_sh" / "train" / "000006").exists()
    again = run_generation(_config(GenerationConfig, root, out, num_scenes=5, resume=True, **base),
                           [env], objs, mesh=mesh)
    assert again.records == []


def test_sharded_dynamic_mode_tracks_motion(root, tmp_path):
    env, objs = _assets(root, Asset, region=(0.05, 0.05), height=(0.25, 0.3), n_objects=1)
    config = _config(GenerationConfig, root, tmp_path / "out", dataset_name="dyn_sh", num_scenes=2,
                     min_num_objects=1, max_num_objects=1, num_camera_interpolation_steps=4,
                     simulation_steps=60, mode="dynamic", seed=2, splat_budget=4000)
    run_generation(config, [env], objs, mesh=cpu_lanes(2))
    gt = json.loads((tmp_path / "out" / "dyn_sh" / "train" / "000001" / "scene_gt.json").read_text())
    t0 = np.asarray(gt["0"][0]["T_m2w"]).reshape(4, 4)[:3, 3]
    t3 = np.asarray(gt["3"][0]["T_m2w"]).reshape(4, 4)[:3, 3]
    assert np.linalg.norm(t3 - t0) > 1e-4  # falling between frames
    traj = json.loads((tmp_path / "out" / "dyn_sh" / "engine" / "000001_simulation_steps.json").read_text())
    assert len(traj["trajectory"]) == 2 and len(next(iter(traj["trajectory"].values()))) == 60  # bodies, steps


def test_sharded_matches_sequential_schema(root, tmp_path):
    """Sequential and sharded paths write interoperable scene trees (not the
    same scenes: the sequential path interleaves its draws with its drops)."""
    env, objs = _assets(root, Asset, region=(0.05, 0.05), height=(0.2, 0.25), n_objects=1)
    common = dict(num_scenes=2, min_num_objects=1, max_num_objects=1, simulation_steps=15, seed=5,
                  splat_budget=4000, convert_scenewise_to_imagewise=False)
    run_generation(_config(GenerationConfig, root, tmp_path / "a", dataset_name="seq", **common),
                   [env], objs, device="cpu")
    run_generation(_config(GenerationConfig, root, tmp_path / "b", dataset_name="sh", **common),
                   [env], objs, mesh=cpu_lanes(2))
    assert not (tmp_path / "b" / "sh" / "train" / "000001" / "scene_gt_info.json").exists()
    for sid in (1, 2):
        a = tmp_path / "a" / "seq" / "train" / f"{sid:06d}"
        b = tmp_path / "b" / "sh" / "train" / f"{sid:06d}"
        ga, gb = json.loads((a / "scene_gt.json").read_text()), json.loads((b / "scene_gt.json").read_text())
        assert set(ga) == set(gb) and ga["0"][0].keys() == gb["0"][0].keys()
        assert {e["obj_id"] for e in ga["0"]} == {e["obj_id"] for e in gb["0"]}
        ca, cb = (json.loads((s / "scene_camera.json").read_text()) for s in (a, b))
        np.testing.assert_allclose(ca["0"]["cam_K"], cb["0"]["cam_K"], rtol=1e-5)
        assert sorted(p.relative_to(a) for p in a.rglob("*.png")) == sorted(p.relative_to(b) for p in b.rglob("*.png"))


# -- (f) the roster rehearsal, small --------------------------------------------------------------------


def test_small_roster_rehearsal_scores_its_own_poses(tmp_path):
    """3 environments, 6 objects of both rosters with their dataset ids, 4
    scenes at 48x40 on 2 lanes, static and dynamic, every camera mode:
    ``check_bop_dataset`` clean, gt-info, NDDS and targets written,
    ``score_bop19`` with the written poses as estimates AR >= 0.99 (mssd and
    mspd exactly 1), and ``models_info.json`` equal to what the JAX package
    writes for the same meshes."""
    data, out = tmp_path / "data", tmp_path / "out"
    envs, objs = build_roster_dataset(
        data, [ENV_CLASSES[n] for n in ("Asphalt", "Tiles", "Wood")],
        [YCB_CLASSES[n] for n in ("CrackerBox", "Spam", "Banana")]
        + [CUP_NOODLE_CLASSES[n] for n in ("CupNoodle01", "CupNoodle12", "CupNoodle30")])
    assert [o.ID for o in objs] == [2, 9, 10, 101, 112, 130]

    def config(mode, cam_mode, upto, seed):
        return GenerationConfig(
            dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
            dataset_base_path=str(out), dataset_name="mini", num_scenes=upto, min_num_objects=2,
            max_num_objects=3, mode=mode, render_width=48, render_height=40, num_cameras=1,
            num_camera_interpolation_steps=2, camera_trajectory_mode=cam_mode, simulation_steps=60,
            save_video=False, seed=seed, resume=True)

    mesh = cpu_lanes(2)
    runs = [("static", "sequence", 2, 1), ("static", "random", 3, 2), ("dynamic", "random+zoom", 4, 3)]
    records = []
    for run in runs:
        records += run_generation(config(*run), envs, objs, mesh=mesh).records
    assert [r["scene_id"] for r in records] == [1, 2, 3, 4]
    finalize_dataset(config(*runs[-1]))
    write_targets_bop19(out, "mini")
    ds = out / "mini"
    report = check_bop_dataset(out, "mini")
    assert report["ok"] and not report["errors"], report["errors"]
    assert all((ds / "train" / f"{s:06d}" / "scene_gt_info.json").exists() for s in range(1, 5))
    assert any((ds / "train_ndds").glob("*.json")) and any((ds / "test_ndds").glob("*.json"))
    targets = json.loads((ds / "test_targets_bop19.json").read_text())
    assert len(targets) == sum(2 * r["n_objects"] for r in records)
    n_est = gt_as_estimates_csv(ds, tmp_path / "gt.csv")
    assert n_est == len(targets)
    scores = score_bop19(tmp_path / "gt.csv", out, "mini")
    assert scores["AR_mssd"] == 1.0 and scores["AR_mspd"] == 1.0 and scores["AR"] >= 0.99, scores

    info = json.loads((ds / "models" / "models_info.json").read_text())
    assert sorted(map(int, info)) == [2, 9, 10, 101, 112, 130]
    j_write_models({o.ID: j_load_mesh(o.urdf_obj_path) for o in objs}, tmp_path / "j_models", 1000.0)
    assert_json_close(json.loads((tmp_path / "j_models" / "models_info.json").read_text()), info, "models_info")
