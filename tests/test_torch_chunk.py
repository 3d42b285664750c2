"""The frame chunk: C frames rendered by one set of launches.

``PEGASUS(frame_chunk=C)`` projects, bins, composites, encodes and packs a
chunk of C frames at once, with one host read of the chunk's sizes
(``bin_splats``) and one readback.  Every frame of a chunk must get the bits
that rendering it alone gives, so:

* ``bin_splats`` of a [C, N] projection equals per-frame ``bin_splats``
  frame by frame (entries, ``tile_start`` offsets, counts, parameters,
  ``max_object_id``), for one posed scene under C cameras and for a scene
  posed C ways;
* ``composite_tiles_torch`` on a chunk's bins is bitwise equal to per-frame
  calls, on scenes and on the long-segment pile-up of three frames;
* the BOP trees ``generate_dataset`` writes at ``frame_chunk`` 1, 3 and 8
  are byte-identical (4 frames: chunks of 1, 3 + 1 and 4), static, dynamic
  and with ``compact_readback``;
* while a chunk renders, no earlier chunk's posed scene is alive;
* ``run_generation`` hands ``config.frame_chunk`` to ``PEGASUS``.

Against the JAX package at the same ``frame_chunk``:
``tests/test_torch_pegasus.py::test_slice_matches_reference``.
"""

import numpy as np
import pytest
import torch

from pegasus_tpu_torch import generate
from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.camera import Camera, CameraBatch
from pegasus_tpu_torch.config import GenerationConfig
from pegasus_tpu_torch.ops.binning import bin_splats
from pegasus_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu_torch.ops.rasterize_cuda import (CHUNK_ENTRIES, composite_tiles,
                                                   composite_tiles_torch, rasterize,
                                                   rasterize_chunk)
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.scene.composition import SceneTemplate, pose_scene
from pegasus_tpu_torch.testing import make_box_cloud, make_plane_cloud, make_tile_pileup
from pegasus_tpu_torch.utils import quaternion as quat

from test_torch_pegasus import MODALITIES, _assets, _config, recorded  # noqa: F401  (fixture)

torch.set_num_threads(1)

W, H, K = 72, 44, 4  # a ragged last tile row and column


def template():
    rng = np.random.default_rng(3)
    env = make_plane_cloud(rng, n=3_000, size=1.2, device="cpu")
    objs = [make_box_cloud(rng, n=400, center=(0.12 * i - 0.1, 0.05 * i, 0.07), object_id=0,
                           rgb=(0.3 * i, 0.5, 0.7), device="cpu") for i in range(K - 1)]
    return SceneTemplate.build(env, objs)


def cameras():
    """Three views; the last with another field of view (the per-camera
    intrinsics of a random+zoom path)."""
    views = [((0.8, 0.6, 0.7), 60, 47), ((0.7, -0.5, 0.6), 60, 47), ((0.2, 0.9, 0.5), 45, 35)]
    return [Camera.look_at(eye=eye, target=(0, 0, 0.05), up=(0, 0, 1), fovx=np.deg2rad(fx),
                           fovy=np.deg2rad(fy), width=W, height=H, device="cpu")
            for eye, fx, fy in views]


def poses(n_bodies, n_poses, seed=5):
    """[C, B, 3, 3] rotations and [C, B, 3] translations (body 0 fixed)."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.normal(size=(n_poses, n_bodies, 4)), dtype=torch.float32)
    R = quat.quat_to_rotmat(q)
    R[:, 0] = torch.eye(3)
    t = torch.tensor(rng.uniform(-0.05, 0.05, (n_poses, n_bodies, 3)), dtype=torch.float32)
    t[:, 0] = 0.0
    return R, t


def assert_bins_match_frames(chunk, frames, n):
    """Chunk bins against each frame's own, frame by frame."""
    n_tiles = frames[0].tile_count.numel()
    assert chunk.n_frames == len(frames) and chunk.tile_count.numel() == len(frames) * n_tiles
    assert chunk.max_object_id == max(b.max_object_id for b in frames)
    offset = 0
    for f, bins in enumerate(frames):
        tiles = slice(f * n_tiles, (f + 1) * n_tiles)
        assert torch.equal(chunk.tile_count[tiles], bins.tile_count)
        assert torch.equal(chunk.tile_start[tiles], bins.tile_start + offset)
        m = bins.entry_splat.numel()
        assert torch.equal(chunk.entry_splat[offset : offset + m], bins.entry_splat + f * n)
        assert torch.equal(chunk.params[:, f * n : (f + 1) * n], bins.params)
        assert torch.equal(chunk.splat_count[f * n : (f + 1) * n], bins.splat_count)
        offset += m
    assert offset == chunk.entry_splat.numel()


@pytest.mark.parametrize("posed", ["static", "dynamic"])
def test_bin_splats_chunk_equals_frames(posed):
    tpl, cams = template(), cameras()
    R, t = poses(tpl.num_bodies, len(cams))
    if posed == "static":
        scene = pose_scene(tpl, R[0], t[0])
        frame_scenes = [scene] * len(cams)
    else:
        scene = pose_scene(tpl, R, t)  # one cloud posed three ways
        frame_scenes = [pose_scene(tpl, R[f], t[f]) for f in range(len(cams))]
        for f, one in enumerate(frame_scenes):  # each pose: the bits of posing it alone
            for name in ("xyz", "rot", "f_rest"):
                assert torch.equal(getattr(scene.pose_frame(f), name), getattr(one, name)), name
    reads = bin_splats.host_reads
    chunk = bin_splats(project_gaussians(scene, CameraBatch.stack(cams)), W, H)
    assert bin_splats.host_reads == reads + 1  # one host read for the chunk
    frames = [bin_splats(project_gaussians(s, c), W, H) for s, c in zip(frame_scenes, cams)]
    assert bin_splats.host_reads == reads + 1 + len(cams)
    assert all(b.entry_splat.numel() > 100 for b in frames)
    assert_bins_match_frames(chunk, frames, tpl.cloud.num_splats)


def test_camera_batch_slices():
    cams = cameras()
    batch = CameraBatch.stack(cams)
    assert len(batch) == 3 and len(batch[1:]) == 2 and batch[1:].width == W
    for f, cam in enumerate(cams):
        assert torch.equal(batch.camera_center[f], cam.camera_center)
        assert batch.tan_x[f].item() == cam.tan_half_fov()[0]
        assert batch.focal_y[f].item() == cam.focal_px()[1]
    with pytest.raises(ValueError, match="uniform resolution"):
        CameraBatch.stack(cams + [Camera.look_at(eye=(1, 1, 1), target=(0, 0, 0), up=(0, 0, 1),
                                                 fovx=1.0, fovy=0.8, width=W + 16, height=H,
                                                 device="cpu")])


def test_composite_tiles_torch_chunk_equals_frames():
    """A chunk of scene views, and the long-segment pile-up (tiles of 10 C +
    37, C - 1, C, C + 1 and 40 entries) in three frames of another seed
    each: the chunk's frames bitwise equal to per-frame calls."""
    scene, cams = template().cloud, cameras()
    chunk = composite_tiles(bin_splats(project_gaussians(scene, CameraBatch.stack(cams)), W, H), W, H, K)
    assert chunk.shape == (len(cams), H, W, 5 + 3 * K + 2)
    for f, cam in enumerate(cams):
        want = composite_tiles(bin_splats(project_gaussians(scene, cam), W, H), W, H, K)
        assert torch.equal(chunk[f], want), f
    assert torch.equal(rasterize_chunk(scene, CameraBatch.stack(cams), max_objects=K).rgb[2],
                       rasterize(scene, cams[2], max_objects=K).rgb)

    c, w, h = CHUNK_ENTRIES, 128, 40
    piles = [make_tile_pileup(np.random.default_rng(5 + f),
                              {0: 10 * c + 37, 1: c - 1, 2: c, 3: c + 1, 12: 40}, w, h, 7, device="cpu")
             for f in range(3)]
    stacked = ProjectedGaussians(*(torch.stack([getattr(p, name) for p in piles])
                                   for name in ProjectedGaussians._fields))
    bins = bin_splats(stacked, w, h)
    out = composite_tiles_torch(bins, w, h, 7)
    assert int(bins.tile_count.max()) > 9 * c  # the long segment survives the cut
    for f in range(3):
        one = bin_splats(ProjectedGaussians(*(x[f] for x in stacked)), w, h)
        assert torch.equal(out[f], composite_tiles_torch(one, w, h, 7)), f


def _tree(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("mode,compact", [("static", False), ("dynamic", False), ("static", True),
                                          ("dynamic", True)])
def test_generate_dataset_trees_identical_across_frame_chunk(recorded, tmp_path, mode, compact):  # noqa: F811
    root, physics_file, env_name = recorded
    trees, stats = {}, {}
    for frame_chunk in (1, 3, 8):
        env, objs = _assets(root, Asset)
        peg = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", frame_chunk=frame_chunk,
                      compact_readback=compact,
                      **_config(root, tmp_path / f"c{frame_chunk}", mode, "random"))
        peg.physics_file, peg.selected_env_name = physics_file, env_name
        peg.init("slice", 1)
        peg.init_start_position()
        reads = bin_splats.host_reads
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        n_frames = len(peg.viewport_cam_list)
        assert n_frames == 4
        assert bin_splats.host_reads - reads == -(-n_frames // frame_chunk)  # one per chunk
        trees[frame_chunk], stats[frame_chunk] = _tree(tmp_path / f"c{frame_chunk}"), peg.last_render_stats
    assert len(trees[1]) > 20
    for frame_chunk in (3, 8):
        assert trees[frame_chunk].keys() == trees[1].keys()
        differ = [str(f) for f, b in trees[1].items() if trees[frame_chunk][f] != b]
        assert not differ, (frame_chunk, differ[:5])
    if not compact:
        assert stats[1]["readback_bytes"] == stats[3]["readback_bytes"] == stats[8]["readback_bytes"]
    else:
        assert all(s["rle_fallback_frames"] == 0 for s in stats.values())


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_chunk_loop_keeps_one_posed_scene(recorded, tmp_path, monkeypatch, mode):  # noqa: F811
    """While a chunk renders, no earlier chunk's posed scene is alive: a
    dynamic chunk's posed clouds (C copies of the whole scene) held through
    the next chunk's render would double the loop's peak device memory."""
    import weakref

    from pegasus_tpu_torch import pegasus

    posed, alive = [], []
    pose, render = pegasus.pose_scene, pegasus.render_chunk

    def recording_pose(*a, **k):
        scene = pose(*a, **k)
        posed.append(weakref.ref(scene))
        return scene

    def counting_render(scene, *a, **k):
        alive.append(sum(ref() is not None for ref in posed))
        return render(scene, *a, **k)

    monkeypatch.setattr(pegasus, "pose_scene", recording_pose)
    monkeypatch.setattr(pegasus, "render_chunk", counting_render)
    root, physics_file, env_name = recorded
    env, objs = _assets(root, Asset)
    peg = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", frame_chunk=1,
                  **_config(root, tmp_path, mode, "random"))
    peg.physics_file, peg.selected_env_name = physics_file, env_name
    peg.init("slice", 1)
    peg.init_start_position()
    peg.generate_dataset(MODALITIES, save_bop=False, save_video=False)
    assert len(posed) == (4 if mode == "dynamic" else 1) and alive == [1] * 4


def test_run_generation_hands_frame_chunk_to_pegasus(monkeypatch, tmp_path):
    seen = {}

    class Stop(Exception):
        pass

    def fake(**kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(generate, "PEGASUS", fake)
    config = GenerationConfig(dataset_path=str(tmp_path), dataset_base_path=str(tmp_path / "out"),
                              frame_chunk=3)
    with pytest.raises(Stop):
        generate.run_generation(config, [], [], device="cpu")
    assert seen["frame_chunk"] == 3 and seen["device"] == "cpu"
