"""gt-info from the masks in memory.

``PEGASUS`` makes its BOP writer with ``collect_gt_info=True``: the writer's
pool derives each object's scene_gt_info record from the mask planes it
encodes, ``save2bop`` keeps the scene's records as ``last_gt_info`` and
``run_generation`` hands them to ``finalize_dataset``, which writes them and
reads back only the finished scenes it was not handed.  Each case holds the
in-memory file byte-identical to what ``calculate_gt_info`` reads back from
the same scene's mask PNGs (on a copy of the scene directory).  Torch only,
on the CPU.
"""

import json
import re
import shutil

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.generate import finalize_dataset, run_generation
from pegasus_tpu_torch.io.bop_writer import (BOPDatasetWriter, calculate_gt_info,
                                             write_scene_gt_info)
from pegasus_tpu_torch.testing import build_synthetic_dataset

torch.set_num_threads(1)

OBJECTS = (("cup_noodles_04", 104), ("cup_noodles_07", 107))
ALL_POINTS = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]
N_FRAMES = 2  # one camera, two interpolation steps


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("gt_info_assets")
    build_synthetic_dataset(path, object_names=[n for n, _ in OBJECTS])
    return path


def _assets(root):
    env = Asset(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3))
    return [env], [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(root)) for n, i in OBJECTS]


def _config(root, out, **over):
    fields = dict(
        dataset_path=str(root), urdf_asset_folder=str(root / "urdf"), dataset_base_path=str(out),
        dataset_name="gt", num_scenes=2, min_num_objects=1, max_num_objects=2,
        render_width=64, render_height=48, num_cameras=1, num_camera_interpolation_steps=2,
        simulation_steps=20, camera_trajectory_mode="sequence", save_video=False, seed=7,
    )
    fields.update(over)
    return GenerationConfig(**fields)


def _read_back(scene, tmp_path) -> bytes:
    """scene_gt_info.json as ``calculate_gt_info`` writes it from a copy of
    ``scene``'s files (its own scene_gt_info.json left out)."""
    copy_root = tmp_path / "read_back"
    shutil.rmtree(copy_root, ignore_errors=True)
    copy = copy_root / "ds" / "train" / scene.name
    shutil.copytree(scene, copy, ignore=shutil.ignore_patterns("scene_gt_info.json"))
    calculate_gt_info(copy_root, "ds", [int(scene.name)])
    return (copy / "scene_gt_info.json").read_bytes()


def _summary_read_back(out: str) -> int:
    return int(re.search(r"gt-info read back from the mask PNGs of (\d+) scene", out).group(1))


@pytest.mark.parametrize("mode, points", [
    ("static", ALL_POINTS),
    ("static", [p for p in ALL_POINTS if p != "seg_sil"]),  # no amodal masks
    ("static", [p for p in ALL_POINTS if p != "seg_vis"]),  # no visible masks
    ("dynamic", ALL_POINTS),
    ("static", [p for p in ALL_POINTS if p != "depth"]),  # rgb writes depth all the same
], ids=["static", "no_seg_sil", "no_seg_vis", "dynamic", "no_depth"])
def test_scene_gt_info_from_memory_is_the_read_back(root, tmp_path, mode, points):
    envs, objs = _assets(root)
    config = _config(root, tmp_path / "out", mode=mode, render_data_points=points)
    stats = run_generation(config, envs, objs, device="cpu")
    assert [r["gt_info_frames"] for r in stats.records] == [N_FRAMES, N_FRAMES]
    for sid in (1, 2):
        scene = tmp_path / "out" / "gt" / "train" / f"{sid:06d}"
        written = (scene / "scene_gt_info.json").read_bytes()
        assert written == _read_back(scene, tmp_path), sid
        info = json.loads(written)
        assert len(info) == N_FRAMES
        assert len(list((scene / "depth").glob("*.png"))) == N_FRAMES  # rgb writes depth too
        if "seg_sil" not in points:
            assert all(r["bbox_obj"] == [-1] * 4 and r["px_count_all"] == 0 and r["visib_fract"] == 0.0
                       for recs in info.values() for r in recs)
        if "seg_vis" not in points:
            assert all(r["bbox_visib"] == [-1] * 4 and r["px_count_visib"] == 0
                       for recs in info.values() for r in recs)
        if points == ALL_POINTS:
            assert any(r["px_count_visib"] > 0 for recs in info.values() for r in recs)


def test_finalize_reads_back_only_scenes_it_was_not_handed(root, tmp_path, capsys):
    """After ``run_generation`` no scene was read back and every frame's
    gt-info came from memory; a finished scene of another run added without
    its scene_gt_info.json is the one ``finalize_dataset(config)`` reads back."""
    envs, objs = _assets(root)
    config = _config(root, tmp_path / "out")
    stats = run_generation(config, envs, objs, device="cpu")
    assert _summary_read_back(capsys.readouterr().out) == 0
    assert sum(r["gt_info_frames"] for r in stats.records) == N_FRAMES * config.num_scenes

    other = _config(root, tmp_path / "other", num_scenes=1, seed=3, convert_scenewise_to_imagewise=False)
    run_generation(other, envs, objs, device="cpu")
    train = tmp_path / "out" / "gt" / "train"
    added = train / "000003"
    shutil.copytree(tmp_path / "other" / "gt" / "train" / "000001", added)
    assert not (added / "scene_gt_info.json").exists()
    kept = {sid: (train / f"{sid:06d}" / "scene_gt_info.json").read_bytes() for sid in (1, 2)}

    assert finalize_dataset(config) == 1
    assert (added / "scene_gt_info.json").read_bytes() == _read_back(added, tmp_path)
    assert {sid: (train / f"{sid:06d}" / "scene_gt_info.json").read_bytes() for sid in (1, 2)} == kept
    assert finalize_dataset(config) == 0  # now every scene's file is current
    # resumed: nothing rendered, nothing read back
    assert len(run_generation(config, envs, objs, device="cpu").records) == 0
    assert _summary_read_back(capsys.readouterr().out) == 0


def _masks(case, rng, h, w):
    """(amodal, visib) of one frame, [H, W, K] each, for the writer's cases."""
    if case == "edges":
        amodal = np.zeros((h, w, 4), bool)
        amodal[0, 0, 0] = True  # one pixel in the corner
        amodal[:, :, 1] = True  # the whole plane
        amodal[h - 3:, w - 2:, 2] = True  # a patch in the far corner; channel 3 stays
        # empty: an object wholly out of view
        visib = amodal.copy()
        visib[:, :, 2] = False  # in view, every pixel occluded
        visib[: h // 2, :, 1] = False
        return amodal, visib
    if case == "crowded":  # K > 32 channels, blobs of random size and place
        k = 40
        amodal = np.zeros((h, w, k), bool)
        for c in range(k - 2):
            y, x = rng.integers(0, h), rng.integers(0, w)
            amodal[y:y + rng.integers(1, h), x:x + rng.integers(1, w), c] = True
        return amodal, amodal & (rng.random((h, w, k)) < 0.7)
    # "uint8": not bool; a value v counts where (v * 255) % 256 > 127, as in the PNG
    values = np.array([0, 1, 2, 128, 129, 255], np.uint8)
    return values[rng.integers(0, 6, (h, w, 3))], values[rng.integers(0, 6, (h, w, 3))]


@pytest.mark.parametrize("case", ["edges", "crowded", "uint8"])
def test_writer_gt_info_equals_read_back(tmp_path, case):
    """The writer alone, on masks that a render rarely gives: empty planes,
    corner pixels, full planes, K > 32, non-bool masks; frames that write
    only one kind of mask or none, and more gt entries than mask channels."""
    rng = np.random.default_rng(5)
    h, w = 30, 42 if case == "uint8" else 40  # a width of whole 8-byte words, or not
    writer = BOPDatasetWriter("ds", tmp_path, {"fx": 50.0, "fy": 50.0, "width": w, "height": h},
                              w, h, None, scene_id=1, writer_threads=3, collect_gt_info=True)
    for frame in range(5):
        amodal, visib = _masks(case, rng, h, w)
        k = amodal.shape[-1]
        n_entries = k + 1 if frame == 4 else k  # frame 4: one entry without masks
        writer.add_scene_gt(frame, np.eye(3), np.zeros(3), [
            {"bullet_id": i, "obj_id": i, "R_init": np.eye(3), "t_init": np.zeros(3)}
            for i in range(n_entries)])
        writer.write_training_data(frame, mask_amodal=None if frame == 1 else amodal,
                                   mask_visib=None if frame == 2 else visib,
                                   asynchronous=frame != 3)
    writer.add_scene_gt(5, np.eye(3), np.zeros(3), [])  # a frame with no objects
    writer.write_training_data(5)
    writer.save_scene_annotations()
    writer.close()

    scene = tmp_path / "ds" / "train" / "000001"
    write_scene_gt_info(scene, writer.scene_gt_info)
    assert (scene / "scene_gt_info.json").read_bytes() == _read_back(scene, tmp_path)
    info = writer.scene_gt_info
    assert list(info) == [str(f) for f in range(6)] and info["5"] == []
    assert info["4"][-1]["bbox_obj"] == [-1] * 4 and info["1"][0]["px_count_all"] == 0
    if case == "edges":
        assert info["0"][0]["bbox_obj"] == [0, 0, 1, 1] and info["0"][1]["bbox_obj"] == [0, 0, w, h]
        assert info["0"][3]["bbox_visib"] == [-1] * 4 and info["0"][3]["visib_fract"] == 0.0
        assert info["0"][2]["px_count_visib"] == 0 and info["0"][2]["px_count_all"] == 6
        assert info["0"][1]["visib_fract"] == 0.5


def test_writer_collects_only_when_asked(tmp_path):
    """The default writer (the sharded path's) keeps no records."""
    writer = BOPDatasetWriter("ds", tmp_path, {"fx": 50.0, "fy": 50.0, "width": 8, "height": 6},
                              8, 6, None, scene_id=1, writer_threads=1)
    writer.add_scene_gt(0, np.eye(3), np.zeros(3), [
        {"bullet_id": 1, "obj_id": 1, "R_init": np.eye(3), "t_init": np.zeros(3)}])
    writer.write_training_data(0, mask_amodal=np.ones((6, 8, 1), bool), mask_visib=np.ones((6, 8, 1), bool))
    writer.save_scene_annotations()
    writer.close()
    assert writer.scene_gt_info is None
