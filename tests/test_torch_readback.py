"""Port parity, the compact readback: ``ops/render.py``'s RLE functions and
``PEGASUS(compact_readback=True)``.

One numpy frame (colours, a depth ramp with steps, blob masks, made from a
seed) is encoded by both packages; ``split_frame_planes`` and
``rle_pack_chunk`` must then give the SAME BYTES as the JAX package's, at a
run budget that fits and at one that overflows (the header reports the uncut
run count, the runs past the budget are dropped, the raw sparse planes come
back as the fallback).  ``rle_unpack_chunk`` is the reference's host decode,
copied: with the fallback it must equal ``unpack_frame_bytes`` of the packed
frame, without it an overflow raises.  ``PEGASUS(compact_readback=True)`` must
write the tree that ``compact_readback=False`` writes, byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegasus_tpu.ops import render as jrender

from pegasus_tpu_torch.assets.registry import Asset
from pegasus_tpu_torch.ops import render
from pegasus_tpu_torch.ops.render import (RLE_BYTES_PER_RUN, RLE_HEADER_BYTES, rle_max_runs,
                                          rle_pack_chunk, rle_unpack_chunk, split_frame_planes,
                                          unpack_frame_bytes)
from pegasus_tpu_torch.pegasus import PEGASUS

from test_torch_pegasus import MODALITIES, _assets, _config, recorded  # noqa: F401  (fixture)

torch.set_num_threads(1)

H, W, K = 40, 48, 3
CHUNK = 2  # frames per chunk in the packing tests; PEGASUS packs min(frame_chunk, frames)


def numpy_frames(seed=0):
    """CHUNK frames as plain numpy: rgb, depth in metres (a ramp with a step,
    so the hi byte has few runs), visible and amodal blob masks."""
    rng = np.random.default_rng(seed)
    frames = []
    for c in range(CHUNK):
        rgb = rng.random((H, W, 3)).astype(np.float32)
        depth = (0.2 + 2.5 * np.linspace(0, 1, H * W, dtype=np.float32).reshape(H, W)
                 + (np.arange(W) > W // 2) * 0.4 * c).astype(np.float32)
        yy, xx = np.mgrid[:H, :W]
        blobs = np.stack([(yy - 10 * (k + 1)) ** 2 + (xx - 12 * (k + 1)) ** 2 < 30 + 10 * c
                          for k in range(K)], axis=-1)
        frames.append(dict(rgb=rgb, depth=depth, alpha=np.ones((H, W), np.float32),
                           mask_visib=blobs & (rng.random((H, W, K)) > 0.1), mask_amodal=blobs,
                           seg_image=np.zeros((H, W, 3), np.float32),
                           vis_weights=blobs.astype(np.float32)))
    return frames


def encoded_by_both():
    """(JAX dense, sparse [C,H,W,*]; port dense, sparse; packed frames [C,H,W,*])."""
    j_planes, t_planes, packed = [], [], []
    for f in numpy_frames():
        j_enc = jrender.encode_frame(jrender.FrameDataPoints(**{k: jnp.asarray(v) for k, v in f.items()}))
        t_enc = render.encode_frame(render.FrameDataPoints(**{k: torch.tensor(v) for k, v in f.items()}))
        j_planes.append(jrender.split_frame_planes(j_enc))
        t_planes.append(split_frame_planes(t_enc))
        packed.append(render.pack_frame_bytes(t_enc).numpy())
        np.testing.assert_array_equal(packed[-1], np.asarray(jrender.pack_frame_bytes(j_enc)))
    stack = lambda planes, i, lib: lib.stack([p[i] for p in planes])
    return ((stack(j_planes, 0, jnp), stack(j_planes, 1, jnp)),
            (stack(t_planes, 0, torch), stack(t_planes, 1, torch)), np.stack(packed))


def test_split_frame_planes_matches_reference():
    (j_dense, j_sparse), (t_dense, t_sparse), packed = encoded_by_both()
    assert t_dense.dtype == t_sparse.dtype == torch.uint8
    assert t_dense.shape == (CHUNK, H, W, 4) and t_sparse.shape == (CHUNK, H, W, 1 + 1)
    np.testing.assert_array_equal(t_dense.numpy(), np.asarray(j_dense))
    np.testing.assert_array_equal(t_sparse.numpy(), np.asarray(j_sparse))
    # (dense, sparse) channel-wise is the pack_frame_bytes layout
    np.testing.assert_array_equal(np.concatenate([t_dense.numpy(), t_sparse.numpy()], -1), packed)
    assert rle_max_runs(CHUNK, H, W, 2) == jrender.rle_max_runs(CHUNK, H, W, 2) == 1024
    assert rle_max_runs(1, 480, 640, 2) == jrender.rle_max_runs(1, 480, 640, 2) == 12800
    assert (RLE_HEADER_BYTES, RLE_BYTES_PER_RUN) == (jrender.RLE_HEADER_BYTES, jrender.RLE_BYTES_PER_RUN)


@pytest.mark.parametrize("budget", ["fits", "overflows"])
def test_rle_pack_chunk_bytes_match_reference(budget):
    """(e) byte for byte against the JAX package, and back through the host
    decode.  The overflowing budget is the forced fallback."""
    (j_dense, j_sparse), (t_dense, t_sparse), packed = encoded_by_both()
    flat = t_sparse.permute(3, 0, 1, 2).reshape(-1).numpy()  # plane-major
    n_runs = 1 + int((flat[1:] != flat[:-1]).sum())
    max_runs = rle_max_runs(CHUNK, H, W, 2) if budget == "fits" else n_runs // 3
    assert (n_runs <= max_runs) == (budget == "fits")

    want, _ = jrender.rle_pack_chunk(j_dense, j_sparse, max_runs)
    got, fallback = rle_pack_chunk(t_dense, t_sparse, max_runs)
    assert got.dtype == torch.uint8 and got.shape == (RLE_HEADER_BYTES + RLE_BYTES_PER_RUN * max_runs
                                                      + t_dense.numel(),)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fallback is t_sparse  # the raw planes, for the host to fetch on overflow
    header = np.frombuffer(got[:RLE_HEADER_BYTES].numpy().tobytes(), "<u4")
    assert header.tolist() == [n_runs, flat.size]  # the uncut run count, the element count

    expect = unpack_frame_bytes(packed, K)
    fetched = []
    data = rle_unpack_chunk(got.numpy(), (CHUNK, H, W), K, max_runs,
                            fallback_sparse=lambda: fetched.append(1) or fallback.numpy())
    assert len(fetched) == (0 if budget == "fits" else 1)  # fetched only on overflow
    assert data.keys() == expect.keys()
    for name in expect:
        np.testing.assert_array_equal(data[name], expect[name], err_msg=name)
    j_data = jrender.rle_unpack_chunk(np.asarray(want), (CHUNK, H, W), K, max_runs,
                                      fallback_sparse=lambda: np.asarray(j_sparse))
    for name in expect:
        np.testing.assert_array_equal(data[name], j_data[name], err_msg=name)
    if budget == "overflows":
        with pytest.raises(ValueError, match=f"RLE overflow \\({n_runs} runs > budget {max_runs}\\)"):
            rle_unpack_chunk(got.numpy(), (CHUNK, H, W), K, max_runs)
        # the slots hold the first max_runs runs: the later ones were dropped
        slots = got[RLE_HEADER_BYTES : RLE_HEADER_BYTES + RLE_BYTES_PER_RUN * max_runs].numpy()
        starts = slots.reshape(max_runs, 5)[:, 1:].astype(np.uint32) @ np.uint32([1, 1 << 8, 1 << 16, 1 << 24])
        assert (np.diff(starts.astype(np.int64)) > 0).all()


def test_rle_constant_planes_and_palette():
    """One run per plane when nothing changes; the palette colours the
    semantic image on the host, as in ``unpack_frame_bytes``."""
    dense = torch.zeros((1, H, W, 4), dtype=torch.uint8)
    sparse = torch.zeros((1, H, W, 2), dtype=torch.uint8)
    sparse[..., 1] = 1  # object 1 visible everywhere
    buf, _ = rle_pack_chunk(dense, sparse, 16)
    assert np.frombuffer(buf[:8].numpy().tobytes(), "<u4").tolist() == [2, 2 * H * W]
    palette = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    data = rle_unpack_chunk(buf.numpy(), (1, H, W), K, 16, palette=palette, with_depth_m=False)
    assert data["mask_visib"][..., 0].all() and not data["mask_visib"][..., 1:].any()
    assert (data["sem_u8"] == [255, 0, 0]).all() and "depth_m" not in data


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_pegasus_compact_readback_writes_the_same_tree(recorded, tmp_path, mode):  # noqa: F811
    """``PEGASUS(compact_readback=True, device="cpu")`` against the default
    readback on the same recorded trajectory: every file equal byte for
    byte, fewer bytes moved, no fallback fetched."""
    root, physics_file, env_name = recorded
    stats = {}
    for name, compact in (("packed", False), ("compact", True)):
        env, objs = _assets(root, Asset)
        peg = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", compact_readback=compact,
                      **_config(root, tmp_path / name, mode, "random"))
        peg.physics_file, peg.selected_env_name = physics_file, env_name
        peg.init("slice", 1)
        peg.init_start_position()
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        stats[name] = peg.last_render_stats
    a, b = tmp_path / "packed", tmp_path / "compact"
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert len(files) > 20 and files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert stats["compact"]["rle_fallback_frames"] == 0 and "rle_fallback_frames" not in stats["packed"]
    # 80x60, two objects, the 4 frames one chunk (frame_chunk=8): 8 + 2K =
    # 12 B/px writer-ready against one buffer of 8 + 5 x 1024 + 4 B/px
    assert stats["packed"]["readback_bytes"] == 4 * 60 * 80 * 12
    assert stats["compact"]["readback_bytes"] == 8 + 5 * 1024 + 4 * 60 * 80 * 4


def test_pegasus_compact_readback_fetches_the_fallback_on_overflow(recorded, tmp_path, monkeypatch):  # noqa: F811
    """With a run budget too small for any frame every frame's raw planes are
    fetched, and the tree is still the same."""
    import pegasus_tpu_torch.pegasus as peg_module

    root, physics_file, env_name = recorded
    trees = {}
    for name, budget in (("roomy", None), ("tight", 4)):
        if budget is not None:
            monkeypatch.setattr(peg_module, "rle_max_runs", lambda *a: budget)
        env, objs = _assets(root, Asset)
        peg = PEGASUS(gs_env_list=[env], gs_object_list=objs, device="cpu", compact_readback=True,
                      **_config(root, tmp_path / name, "static", "sequence"))
        peg.physics_file, peg.selected_env_name = physics_file, env_name
        peg.init("slice", 1)
        peg.init_start_position()
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        trees[name] = (tmp_path / name, peg.last_render_stats)
    assert trees["roomy"][1]["rle_fallback_frames"] == 0 and trees["tight"][1]["rle_fallback_frames"] == 4
    # one chunk of the 4 frames: one buffer, then its raw sparse planes
    assert trees["tight"][1]["readback_bytes"] == 8 + 5 * 4 + 4 * (60 * 80 * 4 + 60 * 80 * 2)
    a, b = trees["roomy"][0], trees["tight"][0]
    for f in sorted(p.relative_to(a) for p in a.rglob("*.png")):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
