"""The writer-ready readback.

``PEGASUS.generate_dataset`` copies each chunk to the host in the layout
the BOP writer and the video worker read (``ops.render.pack_writer_planes``
on the device, ``writer_planes`` on the host: views, no decode).  So:

* its planes equal ``unpack_frame_bytes(pack_frame_bytes(enc))`` bit for
  bit, at K = 1, 3, 6, 8, 9 and 33 (both sides of the host LUT's K <= 8),
  on odd image sizes and on chunks of 1 and 3 frames, with exclusive visible
  masks (the renderer's weights sum to at most 1) and with several visible
  at a pixel;
* with a writer pool made slow and a video worker that reads every frame
  only at ``close``, a scene of 9 frames in chunks of 2 writes the PNGs and
  video frames that the compact readback's host decode gives: no chunk's
  host bytes are overwritten while a frame of it is still held;
  ``writer_ready_frames`` counts every frame, and 0 with
  ``compact_readback=True``;
* ``BOPDatasetWriter.write_training_data`` writes the same PNGs and
  gt-info from 0/255 planes [K, H, W] as from [H, W, K] bool masks.

Torch only, on the CPU.
"""

import time

import numpy as np
import pytest
import torch

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.io import bop_writer
from pegasus_tpu_torch.io.bop_writer import BOPDatasetWriter
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs
from pegasus_tpu_torch.ops.render import (decode_modalities, encode_frame, pack_frame_bytes,
                                          pack_writer_planes, palette_u8, unpack_frame_bytes,
                                          writer_frame_bytes, writer_planes)
from pegasus_tpu_torch.pegasus import PEGASUS
from pegasus_tpu_torch.scene import video
from pegasus_tpu_torch.testing import build_synthetic_dataset

torch.set_num_threads(1)

OBJECTS = (("cup_noodles_04", 104), ("cup_noodles_07", 107))
MODALITIES = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]


def encoded_chunk(rng, c, h, w, k, exclusive, device="cpu"):
    """A chunk's ``encode_frame`` from random weights on ``device``, and its
    palette: visible weights that sum to at most 1 (exclusive masks at the
    0.9 threshold) or not, amodal weights that overlap."""
    vis = rng.random((c, h, w, k + 1), dtype=np.float32)
    if exclusive:
        owner = rng.integers(0, k + 2, (c, h, w))  # k + 1: no object above the threshold
        vis *= 0.1 / (k + 1)
        np.put_along_axis(vis, np.minimum(owner, k)[..., None],
                          np.where(owner <= k, 0.95, 0.05)[..., None], -1)
    else:
        vis = np.where(vis > 0.6, 0.95, vis * 0.5).astype(np.float32)
    out = RenderOutputs(*(torch.from_numpy(a).to(device) for a in (
        rng.random((c, h, w, 3), dtype=np.float32) * 1.2 - 0.1,
        rng.random((c, h, w), dtype=np.float32) * 80.0,
        np.ones((c, h, w), np.float32), vis, vis,
        np.where(rng.random((c, h, w, k + 1)) > 0.5, 0.95, 0.2).astype(np.float32),
    )))
    palette = rng.random((k, 3), dtype=np.float32)
    return encode_frame(decode_modalities(out, torch.from_numpy(palette).to(device))), palette


@pytest.mark.parametrize("exclusive", [True, False], ids=["exclusive", "overlapping"])
@pytest.mark.parametrize("k", [1, 3, 6, 8, 9, 33])
def test_writer_planes_equal_the_host_decode(k, exclusive):
    rng = np.random.default_rng(100 * k + exclusive)
    for c, h, w in ((3, 13, 11), (1, 7, 9)):  # odd sizes; a full chunk of 3 and a tail of 1
        enc, palette = encoded_chunk(rng, c, h, w, k, exclusive)
        assert enc.mask_visib.any() and (enc.mask_visib.sum(-1) > 1).any() == (not exclusive and k > 1)
        buf = pack_writer_planes(enc, torch.from_numpy(palette_u8(palette, k))).numpy()
        assert buf.shape == (c, writer_frame_bytes(h, w, k)) and buf.dtype == np.uint8
        got = writer_planes(buf, h, w, k)
        want = unpack_frame_bytes(pack_frame_bytes(enc).numpy(), k, palette=palette,
                                  with_depth_m=False)
        assert set(got) == set(want)
        for name in ("rgb_u8", "sem_u8", "depth_mm"):
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        for name in ("mask_visib", "mask_amodal"):
            assert got[name].shape == (c, k, h, w) and got[name].dtype == np.uint8
            np.testing.assert_array_equal(got[name], np.moveaxis(want[name], -1, 1) * np.uint8(255),
                                          err_msg=name)
        for name, planes in got.items():  # views of the transfer, each frame's plane contiguous
            assert np.shares_memory(planes, buf), name
            assert all(plane.flags.c_contiguous for plane in planes), name
        assert all(p.flags.c_contiguous for p in got["mask_visib"][0])


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Synthetic assets and a drop recorded by the port's own engine."""
    root = tmp_path_factory.mktemp("assets")
    build_synthetic_dataset(root, object_names=[n for n, _ in OBJECTS])
    env, objs = _assets(root)
    peg = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu",
                  **_config(root, tmp_path_factory.mktemp("physics")))
    peg.init_bullet([env], objs, "physics", 1, 2, 2, random=False)
    return root, peg.physics_file, peg.selected_env_name


def _assets(root):
    env = Asset(OBJECT_NAME="asphalt", ID=1003, TYPE="environment", dataset_path=str(root),
                DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3))
    return env, [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(root)) for n, i in OBJECTS]


def _config(root, out):
    return dict(
        dataset_path=str(root), env_dataset_path=str(root), urdf_asset_folder=str(root / "urdf"),
        render_height=30, render_width=40, num_cameras=3, num_camera_interpolation_steps=3,
        simulation_steps=30, mode="static", camera_trajectory_mode="sequence",
        dataset_base_path=str(out), seed=11, QUIET=True, frame_chunk=2,
    )


class LateVideo:
    """``VideoStreams``' surface; it makes every frame only at ``close``,
    the latest that the real worker could read one."""

    made = []

    def __init__(self, output, width, height, fps=10):
        self.makers, self.frames, self.wait_s, self.drain_s = [], 0, 0.0, 0.0

    def submit(self, make_frame):
        self.makers.append(make_frame)
        self.frames += 1

    def close(self):
        LateVideo.made.append([make() for make in self.makers])


def test_slow_consumers_read_their_own_chunks(recorded, tmp_path, monkeypatch):
    """9 frames in chunks of 2 (5 chunks, the last of 1) with PNG writes
    that wait before reading their planes: the writer-ready tree and video
    frames equal the compact readback's, whose frames are decoded on the
    host and written at full speed."""
    root, physics_file, env_name = recorded
    monkeypatch.setattr(video, "VideoStreams", LateVideo)
    write_png = bop_writer.write_png
    trees, stats = {}, {}
    for name, compact in (("ready", False), ("compact", True)):
        if not compact:
            def slow_write_png(path, image, compression=4):
                time.sleep(0.03)
                write_png(path, image, compression)
            monkeypatch.setattr(bop_writer, "write_png", slow_write_png)
        else:
            monkeypatch.setattr(bop_writer, "write_png", write_png)
        env, objs = _assets(root)
        peg = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", compact_readback=compact,
                      **_config(root, tmp_path / name))
        peg.physics_file, peg.selected_env_name = physics_file, env_name
        peg.init("slice", 1)
        peg.init_start_position()
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=True)
        peg.save2bop()
        stats[name] = peg.last_render_stats
        out = tmp_path / name / "slice"
        trees[name] = {p.relative_to(out): p.read_bytes() for p in sorted(out.rglob("*.png"))}
    assert len(peg.viewport_cam_list) == 9
    assert len(trees["ready"]) == 9 * (3 + 2 * len(OBJECTS)) and trees["ready"].keys() == trees["compact"].keys()
    assert not [str(f) for f, b in trees["compact"].items() if trees["ready"][f] != b]
    ready, compact = LateVideo.made[-2:]
    assert len(ready) == len(compact) == 9
    for a, b in zip(ready, compact):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert stats["ready"]["writer_ready_frames"] == 9 and stats["compact"]["writer_ready_frames"] == 0
    assert stats["ready"]["readback_bytes"] == 9 * writer_frame_bytes(30, 40, len(OBJECTS))
    for s in stats.values():
        assert s["handoff_s"] > 0 and s["slot_wait_s"] >= 0 and s["video_frames"] == 9


@pytest.mark.parametrize("threads", [1, 3])
def test_bop_writer_takes_mask_planes_as_they_are(tmp_path, threads):
    """0/255 planes [K, H, W] and [H, W, K] bool masks: the same PNGs and
    the same gt-info records, on a width of whole 8-byte words and not."""
    out = {}
    for name in ("bool", "planes"):
        for h, w in ((30, 40), (17, 23)):
            writer = BOPDatasetWriter("ds", tmp_path / name / f"{w}", {"fx": 50.0, "fy": 50.0,
                                      "width": w, "height": h}, w, h, None, scene_id=1,
                                      writer_threads=threads, collect_gt_info=True)
            for frame in range(3):
                rng_f = np.random.default_rng(frame + w)
                amodal = rng_f.random((h, w, 4)) > 0.7
                amodal[..., 0] = False  # an empty plane
                visib = amodal & (rng_f.random((h, w, 4)) > 0.5)
                if name == "planes":
                    amodal, visib = (np.ascontiguousarray(np.moveaxis(m, -1, 0)) * np.uint8(255)
                                     for m in (amodal, visib))
                writer.add_scene_gt(frame, np.eye(3), np.zeros(3), [
                    {"bullet_id": i, "obj_id": i, "R_init": np.eye(3), "t_init": np.zeros(3)}
                    for i in range(4)])
                writer.write_training_data(frame, mask_amodal=amodal, mask_visib=visib,
                                           sem_mask=rng_f.integers(0, 255, (h, w, 3), dtype=np.uint8))
            writer.save_scene_annotations()
            writer.close()
            root = tmp_path / name / f"{w}"
            out[name, w] = ({p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*mask*/*.png"))},
                            writer.scene_gt_info)
    for w in (40, 23):
        pngs, info = out["planes", w]
        assert len(pngs) == 3 * (2 * 4 + 1) and pngs == out["bool", w][0]  # masks and sem
        assert info == out["bool", w][1] and info["0"][0]["px_count_all"] == 0
