"""The frame chunk on the card: files and poses independent of ``frame_chunk``.

``PEGASUS(frame_chunk=C, device="cuda")`` replays the committed smoke
trajectory over a small synthetic dataset; the BOP trees written at
``frame_chunk`` 1, 3 and 8 must be byte-identical (4 frames: chunks of 1,
3 + 1 and 4), static, dynamic and with ``compact_readback``, with one
``bin_splats`` host read and one forward-kernel launch per chunk.  A scene
posed three ways at once must equal each pose applied alone, bitwise.  The
writer-ready readback's planes, made on the card at 640x480, equal the host
decode of the bit-packed frame, and its trees the compact readback's.
Needs a CUDA device and ``nvcc``; imports nothing of JAX:

    python -m pytest -m gpu tests/test_torch_chunk_card.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.ops import rasterize_cuda
from pegasus_tpu_torch.ops.binning import bin_splats
from pegasus_tpu_torch.ops.render import (pack_frame_bytes, pack_writer_planes, palette_u8,
                                          unpack_frame_bytes, writer_planes)
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.scene.composition import pose_scene
from pegasus_tpu_torch.testing import SMOKE_ENV, SMOKE_OBJECTS, build_synthetic_dataset

from test_torch_writer_ready import encoded_chunk

pytestmark = pytest.mark.gpu

TRAJECTORY = Path(__file__).resolve().parent / "data" / "torch_smoke_trajectory.json"
MODALITIES = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return build_synthetic_dataset(tmp_path_factory.mktemp("data"),
                                   object_names=[n for n, _ in SMOKE_OBJECTS],
                                   env_splats=6_000, obj_splats=600)


def _pegasus(data, out, device, mode, frame_chunk, compact):
    env = Asset(OBJECT_NAME=SMOKE_ENV[0], ID=SMOKE_ENV[1], TYPE="environment", dataset_path=str(data))
    objs = [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(data)) for n, i in SMOKE_OBJECTS]
    peg = PEGASUS(dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
                  gs_env_list=[env], gs_object_list=objs, mode=mode, camera_trajectory_mode="random",
                  render_height=60, render_width=80, num_cameras=2, num_camera_interpolation_steps=2,
                  simulation_steps=310, dataset_base_path=str(out), seed=3, QUIET=True, device=device,
                  frame_chunk=frame_chunk, compact_readback=compact)
    peg.physics_file, peg.selected_env_name = str(TRAJECTORY), SMOKE_ENV[0]
    peg.init("chunk", 1)
    peg.init_start_position()
    return peg


@pytest.mark.parametrize("mode,compact", [("static", False), ("dynamic", False), ("dynamic", True)])
def test_trees_identical_across_frame_chunk_on_card(cuda, data, tmp_path, mode, compact):
    trees = {}
    for frame_chunk in (1, 3, 8):
        peg = _pegasus(data, tmp_path / f"c{frame_chunk}", cuda, mode, frame_chunk, compact)
        reads, launches = bin_splats.host_reads, rasterize_cuda.composite_tiles.launches
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        n_chunks = -(-len(peg.viewport_cam_list) // frame_chunk)
        assert len(peg.viewport_cam_list) == 4
        assert bin_splats.host_reads - reads == n_chunks
        assert rasterize_cuda.composite_tiles.launches - launches == n_chunks
        root = tmp_path / f"c{frame_chunk}"
        trees[frame_chunk] = {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
                              if p.is_file()}
    assert len(trees[1]) > 20
    for frame_chunk in (3, 8):
        assert trees[frame_chunk].keys() == trees[1].keys()
        differ = [str(f) for f, b in trees[1].items() if trees[frame_chunk][f] != b]
        assert not differ, (frame_chunk, differ[:5])


def test_pose_scene_of_three_poses_on_card(cuda, data, tmp_path):
    peg = _pegasus(data, tmp_path, cuda, "dynamic", 8, False)
    steps = np.array([0, 40, 150])
    R, t = peg._body_poses_at(steps)
    posed = pose_scene(peg.template, R, t)
    for f, step in enumerate(steps):
        R1, t1 = peg._body_poses_at(int(step))
        assert torch.equal(R[f], R1) and torch.equal(t[f], t1)
        one = pose_scene(peg.template, R1, t1)
        for name in ("xyz", "rot", "f_rest"):
            assert torch.equal(getattr(posed.pose_frame(f), name), getattr(one, name)), (f, name)
    peg.pegasus_dataset.close()


@pytest.mark.parametrize("k", [3, 6, 9, 33])
def test_writer_planes_on_card(cuda, k):
    rng = np.random.default_rng(k)
    for exclusive in (True, False):
        enc, palette = encoded_chunk(rng, 8, 480, 640, k, exclusive, device=cuda)
        got = writer_planes(pack_writer_planes(enc, torch.from_numpy(palette_u8(palette, k)).to(cuda))
                            .cpu().numpy(), 480, 640, k)
        want = unpack_frame_bytes(pack_frame_bytes(enc).cpu().numpy(), k, palette=palette,
                                  with_depth_m=False)
        for name in ("rgb_u8", "sem_u8", "depth_mm"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        for name in ("mask_visib", "mask_amodal"):
            np.testing.assert_array_equal(got[name], np.moveaxis(want[name], -1, 1) * np.uint8(255),
                                          err_msg=name)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_writer_ready_tree_equals_compact_on_card(cuda, data, tmp_path, mode):
    trees = {}
    for compact in (False, True):
        peg = _pegasus(data, tmp_path / str(compact), cuda, mode, 3, compact)
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        assert peg.last_render_stats["writer_ready_frames"] == (0 if compact else 4)
        root = tmp_path / str(compact)
        trees[compact] = {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*.png"))}
    assert len(trees[False]) > 20 and trees[False] == trees[True]
