"""Smoke run of the PyTorch/CUDA port (``pegasus_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX.
Phases, each of which fails the run (nonzero exit) on any miss:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build both kernels, the tile compositor ``csrc/composite_tiles.cu`` and
   its backward ``csrc/composite_tiles_bwd.cu``, for sm_90a (one ``nvcc``
   each, started together) and print the build seconds and each
   compiler's report;
3. kernel vs plain: on the 210k-splat bench scene (150k plane + 6 boxes of
   10k, rng 7) and the 1M plane scene (820k plane + 6 boxes of 30k, rng 11),
   each at an orbit and a grazing camera, ``composite_tiles`` against
   ``composite_tiles_torch`` on the same bins: >= 60 dB per channel and
   max |diff| <= 1e-3 x max(1, channel peak); both timed with CUDA events.
   Each shape prints its segment histogram (max, p99 and mean entries per
   tile, and the work items at C = 128, 256, 512 and 1024) and each orbit
   view the forward kernel's time at those four C;
4. full render vs golden: ``rasterize`` against the torch golden
   compositor on the 210k scene, >= 40 dB per channel;
5. generation main path: the ``PEGASUS`` lifecycle replaying the committed
   trajectory ``tests/data/torch_smoke_trajectory.json`` over a synthetic
   dataset (150k-splat environment, six 10k-splat objects) at 640x480 with
   every modality: a static scene of 40 frames and a dynamic scene of 8.
   The BOP tree is checked, and the forward kernel's launch count must
   equal the frames rendered.  Prints frames/s with the host's CPU time and
   load, and per-stage device times;
6. with ``--profile`` only: frames/s of both scenes with and without PNG
   writes, and a ``torch.profiler`` trace of the static scene (device busy
   share, kernel launches, the compositor's share of device time);
7. both kernels vs plain at the training shape (150k-splat box, 512x512,
   K = 1) and at the 210k bench scene's orbit view (K = 7: the seg, vis
   and amodal terms): the forward kernel as in phase 3, and
   ``composite_tiles_backward`` against ``composite_tiles_backward_torch``
   on the same bins and a seeded cotangent, both fed the forward kernel's
   output and per-item partials: per gradient row, cosine >= 0.99999 and
   max |diff| <= 1e-4 x max |gradient| (the two versions sum in another
   order).  Both kernels and both plain versions are timed with
   CUDA events, both kernels also at C = 128, 256, 512 and 1024, each shape
   prints its segment histogram, and each kernel's bound is computed from
   the bins.  Then the long-segment stress case at K = 1 and K = 7: a
   pile-up of splats on a 128x64 image whose tiles hold 10 C + 37, C - 1,
   C and C + 1 entries (most tiles none): the forward kernel against its
   plain version, K3 against its plain version, and two launches of each
   kernel bitwise equal;
8. training main path: ``train_gaussian_splatting_wrapper`` on a synthetic
   COLMAP scene (28 views at 512x512 of the 150k-splat box, ground truth
   rendered by ``rasterize``, 40,000 seed points, capacity 200,000), 600
   iterations, so densification fires at 500 and 600.  Both kernels must
   launch once per iteration, the loss must fall, the alive count must
   exceed the seed count, both PLYs must load back and the PSNR over four
   training views must beat the seed cloud's.  Prints ms/step of whole
   ``train_step`` calls and peak device memory, and with ``--profile`` a
   ``torch.profiler`` trace of 20 steps (device busy share, launches per
   step, each kernel's share of device time, and the device time of each
   stage of ``train_step`` from its ``record_function`` ranges).

The last two lines are one JSON object for the kernels and one for the
device; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
TRAJECTORY = REPO / "tests" / "data" / "torch_smoke_trajectory.json"
MODALITIES = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]
WIDTH, HEIGHT = 640, 480
KERNEL_GATE_DB = 60.0
GOLDEN_GATE_DB = 40.0
KERNEL_SOURCES = ("composite_tiles.cu", "composite_tiles_bwd.cu")
TRAIN_SIZE = 512  # benchmarks/train_step_tpu.py:43-44 and train_asset_512_30k.json
TRAIN_ITERATIONS = 600
SEED_POINTS = 40_000
TRAIN_CAPACITY = 200_000  # TrainConfig's default, as in train_asset_512_30k.json
# H100 SXM peaks (NVIDIA's data sheet, dense): float32 outside the tensor
# cores, and HBM bandwidth
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
# FP32 operations that the least work on these inputs needs, counted from
# the kernels' source.  Per in-image pixel-entry pair, the alpha test
# (entry_alpha: 11 for the quadratic form, 2 min, 1 exp, 1 product, 2 abs and
# 4 compares), which the backward needs only once: S_full = sum_f out[f] gA[f],
# S_ne and the final transmittances are read off the forward's output, so a
# single front-to-back walk gives every entry's gradient.  Per kept pair, the
# forward's compositing (weights, 5 channel sums, 2 transmittances, log1p,
# seg/vis/amodal) and the backward's walk: 1 - alpha, feat.gA (9), the weight
# and prefix (3), dL/dalpha (5), the transmittance, the amodal term (2), rgb
# and depth (4), the clamp test, the chain to mean, conic and opacity (17) and
# the 10 per-entry sums; per kept object pair the vis chain adds 10; per pixel,
# S_full, S_ne and the t_out terms from the forward output.
OPS_ALPHA_TEST = 21
OPS_FWD_KEPT = 19
OPS_BWD_KEPT = 53
OPS_BWD_KEPT_OBJ = 10
FWD_ABS_GATE = 1e-3  # forward kernel vs plain: max |diff| <= this x max(1, channel peak)
CHUNK_SWEEP = (128, 256, 512, 1024)  # entries per work item timed beside CHUNK_ENTRIES

def require(ok, message) -> None:
    """Fail the run (explicitly, so ``python -O`` cannot drop the check)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def psnr_db(a, b, peak: float = 1.0) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * math.log10(peak**2 / mse)


def channel_psnr(ref, out) -> dict:
    """Per-modality PSNR of two RenderOutputs (depth against its own peak)."""
    report = {}
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(out, name)
        peak = max(float(a.max()), 1e-6) if name == "depth" else 1.0
        report[name] = round(psnr_db(a, b, peak), 2)
    return report


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_scenes(device):
    """The reference bench's 210k and 1M scenes (bench.py:261-276, 202-212)."""
    import numpy as np

    from pegasus_tpu_torch.gs.cloud import merge
    from pegasus_tpu_torch.testing import make_box_cloud, make_plane_cloud

    def scene(seed, n_plane, n_box):
        rng = np.random.default_rng(seed)
        env = make_plane_cloud(rng, n=n_plane, size=2.0, device=device)
        objs = [
            make_box_cloud(
                rng, n=n_box, center=(0.1 * i - 0.2, 0.05 * i, 0.08), object_id=i + 1,
                rgb=((0.2 + 0.1 * i) % 1.0, 0.5, (0.9 - 0.1 * i) % 1.0), device=device,
            )
            for i in range(6)
        ]
        return merge([env] + objs)

    return {"210k": scene(7, 150_000, 10_000), "1M": scene(11, 820_000, 30_000)}


def bench_cameras(device):
    """Orbit and grazing views of the reference bench (bench.py:214-246)."""
    import numpy as np

    from pegasus_tpu_torch.camera import Camera

    common = dict(up=(0, 0, 1), fovx=np.deg2rad(60), fovy=np.deg2rad(47),
                  width=WIDTH, height=HEIGHT, device=device)
    return {
        "orbit": Camera.look_at(eye=(0.9, 0.7, 0.9), target=(0, 0, 0.05), **common),
        "grazing": Camera.look_at(eye=(0.85, 0.1, 0.10), target=(-0.6, 0, 0.04), **common),
    }


def forward_vs_plain(label, bins, width, height, k):
    """``composite_tiles`` against ``composite_tiles_torch`` on the same
    bins: every channel >= KERNEL_GATE_DB and max |diff| <= FWD_ABS_GATE x
    max(1, the channel's peak).  Returns the max |diff|."""
    import torch

    from pegasus_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                                       composite_tiles_torch,
                                                       outputs_from_channels)

    k_out = composite_tiles(bins, width, height, k)
    p_out = composite_tiles_torch(bins, width, height, k)
    torch.cuda.synchronize()
    require(torch.isfinite(k_out).all(), f"{label}: non-finite kernel output")
    err = float((k_out - p_out).abs().max())
    bg = (0.0, 0.0, 0.0)
    ref, out = outputs_from_channels(p_out, bg, k), outputs_from_channels(k_out, bg, k)
    db = channel_psnr(ref, out)
    print(f"kernel vs plain {label}: entries={bins.entry_splat.numel()} "
          f"max_abs_err={err:.3e} dB={json.dumps(db)}", flush=True)
    bad = {n: v for n, v in db.items() if v < KERNEL_GATE_DB}
    require(not bad, f"{label}: kernel vs plain below {KERNEL_GATE_DB} dB: {bad}")
    for n in ref._fields:
        a, b = getattr(ref, n), getattr(out, n)
        limit = FWD_ABS_GATE * max(1.0, float(a.abs().max()))
        diff = float((a - b).abs().max())
        require(diff <= limit, f"{label}: {n} max |diff| {diff} > {limit}")
    return err


def time_pair(kernel, plain, n_kernel: int = 20, n_plain: int = 2):
    """(kernel ms, plain ms, [plain, kernel, kernel, plain] runs): one card,
    one call, the better of two runs each."""
    p1, k1 = cuda_ms(plain, n_plain), cuda_ms(kernel, n_kernel)
    k2, p2 = cuda_ms(kernel, n_kernel), cuda_ms(plain, n_plain)
    return min(k1, k2), min(p1, p2), [p1, k1, k2, p2]


def segment_histogram(label, bins) -> dict:
    """Entries per tile (max, p99, mean) and the work items the kernels
    run at each C of CHUNK_SWEEP; printed."""
    import torch

    from pegasus_tpu_torch.ops.rasterize_cuda import tile_items

    count = bins.tile_count.double()
    hist = {"tiles": count.numel(), "max": int(count.max()),
            "p99": float(torch.quantile(count, 0.99)), "mean": float(count.mean()),
            "items": {c: int(tile_items(bins, c)[0].sum()) for c in CHUNK_SWEEP}}
    print(f"segments {label}: {json.dumps(hist)}", flush=True)
    return hist


def chunk_sweep(label, bins, width, height, k, grad=None) -> dict:
    """The forward kernel (and K3, given a cotangent) at each C of
    CHUNK_SWEEP, in the order of CHUNK_SWEEP and back, the better of two."""
    from pegasus_tpu_torch.ops.composite_vjp import composite_tiles_backward
    from pegasus_tpu_torch.ops.rasterize_cuda import composite_tiles

    runs = {c: [] for c in CHUNK_SWEEP}
    for c in CHUNK_SWEEP + CHUNK_SWEEP[::-1]:
        fwd = cuda_ms(lambda: composite_tiles(bins, width, height, k, c), 20)
        bwd = None
        if grad is not None:
            out, partials = composite_tiles(bins, width, height, k, c, return_partials=True)
            bwd = cuda_ms(lambda: composite_tiles_backward(bins, grad, out, partials, width,
                                                           height, k, c), 20)
        runs[c].append((fwd, bwd))
    sweep = {c: {"fwd_ms": min(f for f, _ in r),
                 "bwd_ms": None if grad is None else min(b for _, b in r)} for c, r in runs.items()}
    print(f"chunk sweep {label}: {json.dumps(sweep)}", flush=True)
    return sweep


def kernel_vs_plain(scenes, cams, max_objects):
    """Phase 3: composite_tiles against composite_tiles_torch on the same bins."""
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import composite_tiles, composite_tiles_torch

    max_abs_err, timings = 0.0, {}
    for sname, scene in scenes.items():
        for cname, cam in cams.items():
            proj = project_gaussians(scene, cam)
            bins = bin_splats(proj, WIDTH, HEIGHT)
            hist = segment_histogram(f"{sname} {cname}", bins)
            err = forward_vs_plain(f"{sname} {cname}", bins, WIDTH, HEIGHT, max_objects)
            max_abs_err = max(max_abs_err, err)
            if cname == "orbit":
                ms, plain_ms, runs = time_pair(
                    lambda: composite_tiles(bins, WIDTH, HEIGHT, max_objects),
                    lambda: composite_tiles_torch(bins, WIDTH, HEIGHT, max_objects))
                bound_ms, bound_by = compositor_bounds(bins, WIDTH, HEIGHT, max_objects)["fwd"]
                sweep = chunk_sweep(f"{sname} orbit", bins, WIDTH, HEIGHT, max_objects)
                timings[sname] = {"ms": ms, "plain_ms": plain_ms, "runs_ms": runs,
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "hist": hist, "sweep": sweep}
                print(f"composite time {sname} orbit: kernel {runs[1]:.4f}/{runs[2]:.4f} ms, "
                      f"plain {runs[0]:.4f}/{runs[3]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
                      flush=True)
    return max_abs_err, timings


def golden_parity(scene, cam, max_objects):
    """Phase 4: the full render against the torch golden compositor."""
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.ops.rasterize_ref import rasterize_reference

    bg = (0.1, 0.1, 0.1)
    ref = rasterize_reference(scene, cam, background=bg, max_objects=max_objects)
    out = rasterize(scene, cam, background=bg, max_objects=max_objects)
    db = channel_psnr(ref, out)
    print(f"full render vs golden 210k orbit dB={json.dumps(db)}", flush=True)
    bad = {k: v for k, v in db.items() if v < GOLDEN_GATE_DB}
    require(not bad, f"render vs golden below {GOLDEN_GATE_DB} dB: {bad}")


def check_bop_tree(out_root: Path, name: str, scene_id: int, n_frames: int, n_obj: int):
    """The BOP tree of one scene: JSONs with one entry per frame and one PNG
    per modality per frame; images non-trivial."""
    import numpy as np

    base = out_root / name
    scene = base / "train" / f"{scene_id:06d}"
    require((base / "camera.json").exists(), "camera.json missing")
    minfo = json.loads((base / "models" / "models_info.json").read_text())
    require(len(minfo) == n_obj, minfo.keys())
    gt = json.loads((scene / "scene_gt.json").read_text())
    cam = json.loads((scene / "scene_camera.json").read_text())
    require(sorted(map(int, gt)) == list(range(n_frames)), sorted(gt))
    require(sorted(map(int, cam)) == list(range(n_frames)), sorted(cam))
    require(all(len(v) == n_obj for v in gt.values()), "scene_gt entry without every object")
    counts = {sub: len(list((scene / sub).glob("*.png")))
              for sub in ("rgb", "depth", "mask", "mask_visib", "sem_mask")}
    want = {"rgb": n_frames, "depth": n_frames, "mask": n_frames * n_obj,
            "mask_visib": n_frames * n_obj, "sem_mask": n_frames}
    require(counts == want, (counts, want))

    rgb, depth = _read_png(scene / "rgb" / "000000.png"), _read_png(scene / "depth" / "000000.png")
    require(rgb.shape == (HEIGHT, WIDTH, 3) and rgb.mean() > 10, rgb.mean())
    require(depth.dtype == np.uint16 and 200 < depth[depth > 0].mean() < 5000, "depth PNG not plausible millimeters")
    visible = sum(int((_read_png(p) > 127).sum()) for p in (scene / "mask_visib").glob("*.png"))
    require(visible > 0, "no object pixel visible in any frame")


def _read_png(path):
    """Minimal reader for the writer's own PNGs (filter 0, 8/16-bit)."""
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    pos, idat, w = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            w, h, bits, ctype = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    dtype = np.dtype(">u2") if bits == 16 else np.dtype("u1")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    require((rows[:, 0] == 0).all(), "unexpected PNG filter")
    img = rows[:, 1:].copy().view(dtype).reshape(h, w, ch)
    return (img[..., 0] if ch == 1 else img).astype(dtype.newbyteorder("="))


def scene_pegasus(data: Path, out: Path, name: str, mode: str, num_cameras: int,
                  n_interp: int, device):
    """A PEGASUS replaying the committed trajectory, set up up to
    ``init_start_position`` (the loading is not part of any timing)."""
    from pegasus_tpu_torch.assets.registry import Asset
    from pegasus_tpu_torch.pegasus import PEGASUS
    from pegasus_tpu_torch.testing import SMOKE_ENV, SMOKE_OBJECTS

    env = Asset(OBJECT_NAME=SMOKE_ENV[0], ID=SMOKE_ENV[1], TYPE="environment",
                dataset_path=str(data))
    objs = [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(data)) for n, i in SMOKE_OBJECTS]
    peg = PEGASUS(
        dataset_path=str(data), env_dataset_path=str(data),
        urdf_asset_folder=str(data / "urdf"), gs_env_list=[env], gs_object_list=objs,
        mode=mode, camera_trajectory_mode="random", render_height=HEIGHT,
        render_width=WIDTH, num_cameras=num_cameras, simulation_steps=310,
        num_camera_interpolation_steps=n_interp, dataset_base_path=str(out),
        seed=3, QUIET=True, device=device,
    )
    peg.physics_file = str(TRAJECTORY)
    peg.selected_env_name = SMOKE_ENV[0]
    peg.init(name, 1)
    peg.init_start_position()
    return peg


def run_scene(data: Path, out: Path, name: str, mode: str, num_cameras: int,
              n_interp: int, device, save_bop: bool = True):
    """Generate and save one scene; returns (pegasus, frames, host stats).

    Host stats: wall seconds of ``generate_dataset`` + ``save2bop``, the
    process's CPU seconds over the same span (all threads, the PNG writer
    pool included) and the 1-minute load average at its start."""
    from pegasus_tpu_torch.testing import SMOKE_OBJECTS

    peg = scene_pegasus(data, out, name, mode, num_cameras, n_interp, device)
    load = os.getloadavg()[0]
    t0, c0 = time.perf_counter(), time.process_time()
    peg.generate_dataset(MODALITIES, save_bop=save_bop, save_video=False)
    peg.save2bop()
    host = {"wall_s": time.perf_counter() - t0, "cpu_s": time.process_time() - c0,
            "loadavg_1m": load}
    n_frames = len(peg.viewport_cam_list)
    if save_bop:
        check_bop_tree(out, name, 1, n_frames, len(SMOKE_OBJECTS))
    return peg, n_frames, host


def profile_main_path(data: Path, out: Path, device, card: str) -> None:
    """``--profile``: frames/s of both scenes with and without PNG writes
    (runs in the order without, with, with, without), each with its host
    stats; then one ``torch.profiler`` trace of the static scene with PNG
    writes: device time, kernel launches and the compositor's share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for mode, n_cams in (("static", 10), ("dynamic", 2)):
        for j, save_bop in enumerate((False, True, True, False)):
            _, n, host = run_scene(data, out, f"prof_{mode}_{j}", mode, n_cams, 4,
                                   device, save_bop=save_bop)
            print(f"profile {mode} save_bop={save_bop}: {n} frames "
                  f"{n / host['wall_s']:.3f} frames/s "
                  f"cpu_s={host['cpu_s']:.3f} wall_s={host['wall_s']:.4f} "
                  f"loadavg_1m={host['loadavg_1m']:.2f} card={card}", flush=True)

    peg = scene_pegasus(data, out, "prof_trace", "static", 10, 4, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device-side rows only: a CPU op's self device time repeats its kernels'
    device_rows = [a for a in avgs if a.device_type == DeviceType.CUDA]
    device_ms = sum(a.self_device_time_total for a in device_rows) / 1e3
    launches = sum(a.count for a in avgs
                   if a.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    launch_host_ms = sum(a.self_cpu_time_total for a in avgs
                         if a.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")) / 1e3
    comp_ms = sum(a.self_device_time_total for a in device_rows if "composite_tiles" in a.key) / 1e3
    top_ops = sorted((a for a in avgs if a.key.startswith("aten::")),
                     key=lambda a: -a.count)[:5]
    n = len(peg.viewport_cam_list)
    print(f"profile trace static {n} frames (PNG writes on): wall {wall_ms:.3f} ms, "
          f"device time {device_ms:.3f} ms (busy share {device_ms / wall_ms:.4f}), "
          f"{launches} kernel launches ({launches / n:.1f}/frame, host {launch_host_ms:.3f} ms), "
          f"composite_tiles {comp_ms:.3f} ms ({100 * comp_ms / device_ms:.2f} % of device time); "
          f"most-called ops {[(a.key, a.count) for a in top_ops]} card={card}", flush=True)
    print(avgs.table(sort_by="self_device_time_total", row_limit=12), flush=True)


def stage_times(peg, card: str):
    """Per-stage device time of the static scene's frames, by CUDA events."""
    import torch

    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                                       outputs_from_channels)
    from pegasus_tpu_torch.ops.render import (decode_modalities, encode_frame,
                                              pack_frame_bytes)
    from pegasus_tpu_torch.scene.composition import pose_scene

    k = len(peg.semantic_colors) + 1
    t_pose = cuda_ms(lambda: pose_scene(peg.template, *peg._body_poses_at(peg._initial_step)), 5)
    scene = pose_scene(peg.template, *peg._body_poses_at(peg._initial_step))
    names = ("project", "bin", "composite", "pack")
    total = dict.fromkeys(names, 0.0)
    cams = peg.viewport_cam_list
    for cam in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        proj = project_gaussians(scene, cam)
        ev[1].record()
        bins = bin_splats(proj, cam.width, cam.height)
        ev[2].record()
        out = composite_tiles(bins, cam.width, cam.height, k)
        ev[3].record()
        frame = decode_modalities(outputs_from_channels(out, peg.background, k),
                                  peg._semantic_colors_dev)
        pack_frame_bytes(encode_frame(frame))
        ev[4].record()
        ev[4].synchronize()
        for i, n in enumerate(names):
            total[n] += ev[i].elapsed_time(ev[i + 1])
    per = {n: round(v / len(cams), 4) for n, v in total.items()}
    per["pose_once_per_scene"] = round(t_pose, 4)
    print(f"stage device ms/frame (static scene, {len(cams)} frames, 210k splats, "
          f"{WIDTH}x{HEIGHT}): {json.dumps(per)} card={card}", flush=True)


def build_kernels():
    """Phase 2: one nvcc per kernel source, started together."""
    from pegasus_tpu_torch.ops import rasterize_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(rasterize_cuda.build_kernel, KERNEL_SOURCES))
    print(f"built {[p.name for p, _ in built]} in {time.perf_counter() - t0:.2f} s", flush=True)
    for (path, log) in built:
        print(f"{path.name}:\n{log.strip()}", flush=True)


def pair_counts(bins, width, height, chunk: int = 128):
    """(in-image pixel-entry pairs, kept pairs, kept pairs of object splats)
    of one frame's bins: the alpha tests and the compositing work the
    kernels must do on these inputs (kept: the kernels' keep rule, from the
    plain versions' walk)."""
    from pegasus_tpu_torch.ops.binning import P_OBJ
    from pegasus_tpu_torch.ops.rasterize_cuda import tile_chunks

    pairs = kept = kept_obj = 0
    for c in tile_chunks(bins, chunk):
        inside = ((c.px < width) & (c.py < height))[:, :, None]
        pairs += int((inside & c.ok[:, None, :]).sum())
        kept_in = inside & c.keep
        kept += int(kept_in.sum())
        kept_obj += int((kept_in & (c.p[P_OBJ] != 0)[:, None, :]).sum())
    return pairs, kept, kept_obj


def kernel_bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = ops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compositor_bounds(bins, width, height, k):
    """Bounds of the forward and backward kernels on these bins: each input
    read once, each output written once, the counted operations.  The
    backward's least work reads the forward's output besides the cotangent
    (one walk instead of two, see OPS_BWD_KEPT)."""
    pairs, kept, kept_obj = pair_counts(bins, width, height)
    n, m, n_tiles = bins.params.shape[1], bins.entry_splat.numel(), bins.tile_start.numel()
    inputs = 4 * (12 * n + m + 2 * n_tiles)
    image = 4 * height * width * (5 + 3 * k + 2)
    per_pixel = height * width * (2 * (5 + k) + 2 * k + 2)
    fwd = kernel_bound(OPS_ALPHA_TEST * pairs + OPS_FWD_KEPT * kept, inputs + image)
    bwd = kernel_bound(OPS_ALPHA_TEST * pairs + OPS_BWD_KEPT * kept + OPS_BWD_KEPT_OBJ * kept_obj
                       + per_pixel, inputs + 2 * image + 4 * 10 * m)
    return {"pairs": pairs, "kept": kept, "kept_obj": kept_obj, "fwd": fwd, "bwd": bwd}


def train_box_cloud(device):
    """benchmarks/train_step_tpu.py:59-63: 150k splats on a box, rng 7."""
    import numpy as np

    from pegasus_tpu_torch.testing import make_box_cloud

    return make_box_cloud(np.random.default_rng(7), n=150_000, half_extents=(0.15, 0.15, 0.18),
                          rgb=(0.6, 0.4, 0.3), object_id=0, device=device)


def train_camera(device):
    """benchmarks/train_step_tpu.py:64-69: the box seen from (0.6, 0.45, 0.5)."""
    from pegasus_tpu_torch.camera import Camera

    return Camera.look_at(eye=(0.6, 0.45, 0.5), target=(0, 0, 0), up=(0, 0, 1),
                          fovx=math.radians(55), fovy=math.radians(55),
                          width=TRAIN_SIZE, height=TRAIN_SIZE, device=device)


def backward_rows_vs_plain(label, bins, grad, out, partials, width, height, k, chunk_entries):
    """K3 against its plain version, both fed the forward kernel's output
    and partials: per gradient row, cosine >= 0.99999 and max |diff| <=
    1e-4 x max |gradient|.  Returns [(cosine, max |diff|, max |g|)]."""
    import torch

    from pegasus_tpu_torch.ops.composite_vjp import (composite_tiles_backward,
                                                     composite_tiles_backward_torch)

    got = composite_tiles_backward(bins, grad, out, partials, width, height, k, chunk_entries)
    want = composite_tiles_backward_torch(bins, grad, out, partials, width, height, k,
                                          chunk_entries=chunk_entries)
    torch.cuda.synchronize()
    require(torch.isfinite(got).all(), f"{label}: non-finite backward kernel output")
    rows = []
    for r in range(got.shape[0]):
        a, b = got[r].double(), want[r].double()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        cos = float(a @ b / (a.norm() * b.norm())) if scale > 0 else float(err == 0)
        rows.append((cos, err, scale))
        require(cos >= 0.99999 and err <= 1e-4 * scale,
                f"{label} row {r}: cosine {cos} max|diff| {err} vs max|g| {scale}")
    return rows


def backward_vs_plain(label, bins, width, height, k, card):
    """Phase 7 at one shape: the forward kernel and K3 against their plain
    versions on the same bins, each timed (plain, kernel, kernel, plain)."""
    import torch

    from pegasus_tpu_torch.ops.composite_vjp import (composite_tiles_backward,
                                                     composite_tiles_backward_torch)
    from pegasus_tpu_torch.ops.rasterize_cuda import (CHUNK_ENTRIES, composite_tiles,
                                                       composite_tiles_torch, num_channels)

    hist = segment_histogram(label, bins)
    fwd_err = forward_vs_plain(label, bins, width, height, k)
    dev = bins.params.device
    g = torch.randn((height, width, num_channels(k)), generator=torch.Generator().manual_seed(k)).to(dev)
    fwd_out, partials = composite_tiles(bins, width, height, k, return_partials=True)
    rows = backward_rows_vs_plain(label, bins, g, fwd_out, partials, width, height, k, CHUNK_ENTRIES)
    f_ms, f_plain_ms, f_runs = time_pair(lambda: composite_tiles(bins, width, height, k),
                                         lambda: composite_tiles_torch(bins, width, height, k))
    ms, plain_ms, runs = time_pair(
        lambda: composite_tiles_backward(bins, g, fwd_out, partials, width, height, k),
        lambda: composite_tiles_backward_torch(bins, g, fwd_out, partials, width, height, k),
        n_plain=1)
    bounds = compositor_bounds(bins, width, height, k)
    sweep = chunk_sweep(label, bins, width, height, k, g)
    out = {"entries": bins.entry_splat.numel(), "max_abs_err": max(e for _, e, _ in rows),
           "min_cosine": min(c for c, _, _ in rows),
           "max_rel_err": max(e / s for _, e, s in rows if s > 0),
           "ms": ms, "plain_ms": plain_ms, "runs_ms": runs,
           "fwd_ms": f_ms, "fwd_plain_ms": f_plain_ms, "fwd_max_abs_err": fwd_err,
           "hist": hist, "sweep": sweep, **bounds}
    print(f"backward kernel vs plain {label}: entries={out['entries']} pairs={bounds['pairs']} "
          f"kept={bounds['kept']} kept_obj={bounds['kept_obj']} min_cosine={out['min_cosine']:.8f} "
          f"max_rel_err={out['max_rel_err']:.3e} max_abs_err={out['max_abs_err']:.3e}; "
          f"K3 {runs[1]:.4f}/{runs[2]:.4f} ms, plain {runs[0]:.4f}/{runs[3]:.4f} ms; "
          f"forward kernel {f_runs[1]:.4f}/{f_runs[2]:.4f} ms, plain {f_runs[0]:.4f}/{f_runs[3]:.4f} ms; "
          f"bound fwd {bounds['fwd'][0]:.4f} ms ({bounds['fwd'][1]}), "
          f"bwd {bounds['bwd'][0]:.4f} ms ({bounds['bwd'][1]}) card={card}", flush=True)
    return out


def long_segment_stress(device, k, card):
    """Phase 7's stress case: splats piled onto a few tiles of a 128x64
    image (tile 0 holds 10 C + 37 entries, tiles 1-3 C - 1, C and C + 1,
    tile 12 a short segment, the rest none).  Both kernels against their
    plain versions, and two launches of each kernel bitwise equal.  Returns the
    largest forward and backward |diff|."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.composite_vjp import composite_tiles_backward
    from pegasus_tpu_torch.ops.rasterize_cuda import CHUNK_ENTRIES, composite_tiles
    from pegasus_tpu_torch.testing import make_tile_pileup

    c, w, h = CHUNK_ENTRIES, 128, 64
    label = f"stress K={k}"
    proj = make_tile_pileup(np.random.default_rng(5), {0: 10 * c + 37, 1: c - 1, 2: c, 3: c + 1, 12: 40},
                            w, h, k, device=device)
    bins = bin_splats(proj, w, h)
    counts = bins.tile_count.tolist()
    require(counts[:4] == [10 * c + 37, c - 1, c, c + 1] and 0 in counts, f"{label}: counts {counts}")
    hist = segment_histogram(label, bins)
    fwd_err = forward_vs_plain(label, bins, w, h, k)
    out, partials = composite_tiles(bins, w, h, k, return_partials=True)
    again = composite_tiles(bins, w, h, k)
    torch.cuda.synchronize()
    require(torch.equal(out, again), f"{label}: two forward launches differ")
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(k)).to(device)
    rows = backward_rows_vs_plain(label, bins, g, out, partials, w, h, k, c)
    grads = [composite_tiles_backward(bins, g, out, partials, w, h, k, c) for _ in range(2)]
    torch.cuda.synchronize()
    require(torch.equal(*grads), f"{label}: two K3 launches differ")
    bwd_err = max(e for _, e, _ in rows)
    print(f"long-segment stress K={k}: tiles {counts[:4]} + one of 40, items {hist['items'][c]}, "
          f"both kernels bitwise repeatable, forward max_abs_err {fwd_err:.3e}, K3 min_cosine "
          f"{min(cs for cs, _, _ in rows):.8f} max_abs_err {bwd_err:.3e} card={card}", flush=True)
    return fwd_err, bwd_err


def training_scene(root: Path, device):
    """A synthetic COLMAP scene under ``root``: 28 hemisphere views of the
    150k-splat box at 512x512 (ground truth rendered by the port's
    ``rasterize``) and 40,000 seed points drawn from the box's splats with
    5 mm of noise, coloured by their splats' DC colour."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.camera import Camera
    from pegasus_tpu_torch.io import colmap as cio
    from pegasus_tpu_torch.io.png import write_png
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.testing import make_colmap_hemisphere
    from pegasus_tpu_torch.utils import sh as shlib
    from pegasus_tpu_torch.utils.pose import focal2fov

    gt = train_box_cloud(device)
    focal = TRAIN_SIZE / (2 * math.tan(math.radians(55) / 2))  # 55 degree field of view
    cams, images = make_colmap_hemisphere(n_images=28, radius=0.9, width=TRAIN_SIZE,
                                          height=TRAIN_SIZE, focal=focal)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    cio.write_cameras_binary(cams, sparse / "cameras.bin")
    cio.write_images_binary(images, sparse / "images.bin")
    rng = np.random.default_rng(3)
    idx = rng.choice(gt.num_splats, SEED_POINTS, replace=False)
    xyz = gt.xyz[idx].cpu().numpy() + rng.normal(size=(SEED_POINTS, 3)) * 0.005
    rgb = (np.clip(shlib.sh2rgb(gt.f_dc[idx, 0].cpu().numpy()), 0, 1) * 255).astype(np.uint8)
    none = np.zeros(0, np.int32)
    cio.write_points3d_binary(
        {i + 1: cio.ColmapPoint3D(i + 1, xyz[i], rgb[i], 0.1, none, none) for i in range(SEED_POINTS)},
        sparse / "points3D.bin",
    )
    (root / "images").mkdir()
    fov = focal2fov(focal, TRAIN_SIZE)
    with torch.no_grad():
        for im in images.values():
            cam = Camera.from_colmap(im.qvec, im.tvec, fov, fov, TRAIN_SIZE, TRAIN_SIZE, device=device)
            rgb_img = torch.clamp(rasterize(gt, cam, max_objects=1).rgb, 0, 1)
            write_png(root / "images" / im.name, (rgb_img * 255).to(torch.uint8).cpu().numpy())


def eval_views(cloud, cams, gts):
    """Mean training loss and PSNR of ``cloud`` over views (forward kernel)."""
    import torch

    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.training.losses import gs_loss

    loss, db = 0.0, 0.0
    with torch.no_grad():
        for cam, gt in zip(cams, gts):
            pred = torch.clamp(rasterize(cloud, cam, max_objects=1).rgb, 0, 1)
            loss += float(gs_loss(pred, gt)[0]) / len(cams)
            db += psnr_db(pred, gt) / len(cams)
    return loss, db


def stage_split(prof, prefix: str):
    """Device ms per ``record_function`` range named ``prefix<stage>``:
    each device event is charged to the range whose host interval holds the
    CUDA call that queued it (matched by correlation id), whatever thread
    made the call: the backward's launches come from autograd's device
    thread while the step's thread waits inside its range.  Returns
    ({stage: ms}, ms of device events charged to no range)."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(prefix):]) for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith(prefix)]
    queued_at = {e.id: e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    split, unassigned = {name: 0.0 for _, _, name in ranges}, 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(prefix):
            continue
        t = queued_at.get(e.id)
        stage = next((name for lo, hi, name in ranges if t is not None and lo <= t <= hi), None)
        ms = e.time_range.elapsed_us() / 1e3
        if stage is None:
            unassigned += ms
        else:
            split[stage] += ms
    return split, unassigned


def profile_training(trainer, state, cams, gts, card, steps: int = 20):
    """``--profile``: a torch.profiler trace of ``steps`` training steps,
    with the device time of each of ``train_step``'s stages; and the host
    cost of one of its ``record_function`` ranges with no profiler on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    t0 = time.perf_counter()
    for _ in range(10_000):
        with record_function("chip_smoke/idle"):
            pass
    range_us = (time.perf_counter() - t0) * 1e6 / 10_000
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = trainer.train_step(state, cams[i % len(cams)], gts[i % len(gts)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device-side kernel rows only: no range's device-side copy
    device_rows = [a for a in avgs
                   if a.device_type == DeviceType.CUDA and not a.key.startswith("train_step/")]
    device_ms = sum(a.self_device_time_total for a in device_rows) / 1e3
    launch_keys = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    launches = sum(a.count for a in avgs if a.key in launch_keys)
    require(device_ms > 0, "the profiler recorded no device time")
    bwd_ms = sum(a.self_device_time_total for a in device_rows if "composite_tiles_bwd" in a.key) / 1e3
    fwd_ms = sum(a.self_device_time_total for a in device_rows
                 if "composite_tiles_kernel" in a.key) / 1e3
    print(f"profile trace training {steps} steps: wall {wall_ms:.3f} ms, device time {device_ms:.3f} ms "
          f"(busy share {device_ms / wall_ms:.4f}), {launches} kernel launches "
          f"({launches / steps:.1f}/step), K3 {bwd_ms:.3f} ms ({100 * bwd_ms / device_ms:.2f} % of "
          f"device time), forward kernel {fwd_ms:.3f} ms ({100 * fwd_ms / device_ms:.2f} %) card={card}",
          flush=True)
    split, unassigned = stage_split(prof, "train_step/")
    per = {n: round(v / steps, 4) for n, v in split.items()}
    print(f"train stage device ms/step (profiler ranges of train_step, {steps} steps, "
          f"{int(state.cloud.alive.sum())} alive): {json.dumps(per)} sum {sum(split.values()) / steps:.4f}, "
          f"outside any range {unassigned / steps:.4f}; one range with no profiler on "
          f"{range_us:.3f} us of host time card={card}", flush=True)
    print(avgs.table(sort_by="self_device_time_total", row_limit=15), flush=True)


def training_main_path(tmp: Path, device, card: str, profile_steps: bool):
    """Phase 8: the training wrapper on the synthetic scene; returns the two
    kernels' launch counts over its run."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.gs.ply import load_gs_ply, read_ply_vertex_data
    from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda
    from pegasus_tpu_torch.scene.dataset import load_colmap_scene
    from pegasus_tpu_torch.training.trainer import (GSTrainer, TrainConfig, init_from_points,
                                                    train_gaussian_splatting_wrapper)

    data, model = tmp / "train_scene", tmp / "train_model"
    t0 = time.perf_counter()
    training_scene(data, device)
    print(f"training scene written in {time.perf_counter() - t0:.2f} s", flush=True)
    capacity = TRAIN_CAPACITY

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rasterize_cuda.composite_tiles.launches = 0
    composite_vjp.composite_tiles_backward.launches = 0
    t0 = time.perf_counter()
    state = train_gaussian_splatting_wrapper(
        str(data), str(model), TEST_ITERATION=(TRAIN_ITERATIONS,), SAVE_ITERATION=(TRAIN_ITERATIONS,),
        iterations=TRAIN_ITERATIONS, capacity=capacity, device=device,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"forward": rasterize_cuda.composite_tiles.launches,
                "backward": composite_vjp.composite_tiles_backward.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(launches == {"forward": TRAIN_ITERATIONS, "backward": TRAIN_ITERATIONS},
            f"training launches {launches} for {TRAIN_ITERATIONS} iterations")

    alive = int(state.cloud.alive.sum())
    require(state.step == TRAIN_ITERATIONS, state.step)
    require(alive > SEED_POINTS, f"alive {alive} after densification <= {SEED_POINTS} seed points")
    out = model / "point_cloud" / f"iteration_{TRAIN_ITERATIONS}"
    ply = load_gs_ply(str(out / "point_cloud.ply"), device=device)
    o3d = read_ply_vertex_data(str(out / "point_cloud_o3d.ply"))
    require(ply.num_splats == alive == len(o3d["x"]), (ply.num_splats, alive, len(o3d["x"])))
    require(all(bool(torch.isfinite(getattr(ply, f)).all()) for f in ("xyz", "opacity", "scale", "rot")),
            "non-finite trained PLY")

    scene = load_colmap_scene(str(data), device=device)
    config = TrainConfig(iterations=TRAIN_ITERATIONS, capacity=capacity)
    views = [0, 7, 14, 21]
    cams = [scene["cameras"][i] for i in views]
    gts = [torch.tensor(scene["images"][i], device=device) for i in views]
    seed = init_from_points(scene["points"], scene["colors"], config, device=device)
    loss0, db0 = eval_views(seed, cams, gts)
    loss1, db1 = eval_views(ply, cams, gts)
    require(loss1 < loss0, f"loss did not fall: {loss0} -> {loss1}")
    require(db1 > db0, f"PSNR did not rise: {db0} -> {db1} dB")
    print(f"training main path: {TRAIN_ITERATIONS} iterations in {wall:.3f} s "
          f"({1e3 * wall / TRAIN_ITERATIONS:.3f} ms/iteration, wrapper wall incl. loading, knn init "
          f"and PLY writes), launches {json.dumps(launches)}, alive {SEED_POINTS} -> {alive} of "
          f"{capacity}, loss {loss0:.5f} -> {loss1:.5f}, PSNR over 4 training views "
          f"{db0:.3f} -> {db1:.3f} dB, peak device memory {peak_gib:.3f} GiB card={card}", flush=True)

    trainer = GSTrainer(config, width=scene["width"], height=scene["height"], device=device)
    all_gts = [torch.tensor(im, device=device) for im in scene["images"]]
    order = np.random.default_rng(1).integers(0, len(all_gts), 40)
    step_cams = [scene["cameras"][i] for i in order]
    step_gts = [all_gts[i] for i in order]
    for i in range(5):  # warm-up
        state, _ = trainer.train_step(state, step_cams[i], step_gts[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(20):
        state, _ = trainer.train_step(state, step_cams[i], step_gts[i])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(f"train_step: {step_ms:.3f} ms/step (host clock over 20 steps ending in synchronize, "
          f"{int(state.cloud.alive.sum())} alive of {capacity}, {TRAIN_SIZE}x{TRAIN_SIZE}) card={card}",
          flush=True)
    if profile_steps:
        profile_training(trainer, state, step_cams, step_gts, card)
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run phase 6 (frames/s with and without PNG writes, profiler trace)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from pegasus_tpu_torch.camera import Camera
    from pegasus_tpu_torch.io.png import _load_native
    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.ops.rasterize_cuda import CHUNK_ENTRIES
    from pegasus_tpu_torch.testing import SMOKE_OBJECTS, build_synthetic_dataset

    dev = torch.device("cuda:0")
    # -- phase 1: the card ----------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- phase 2: build both kernels -----------------------------------------------
    build_kernels()

    # -- phase 3: kernel vs plain -------------------------------------------------
    max_objects = len(SMOKE_OBJECTS) + 1  # render_frame's K for six objects
    scenes = bench_scenes(dev)
    cams = bench_cameras(dev)
    max_abs_err, timings = kernel_vs_plain(scenes, cams, max_objects)

    # -- phase 4: full render vs golden ---------------------------------------------
    golden_parity(scenes["210k"], cams["orbit"], max_objects)
    scene_210k = scenes["210k"]
    del scenes
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="pegasus_smoke_") as tmp:
        # -- phase 5: the generation main path ------------------------------------------
        data, out = Path(tmp) / "data", Path(tmp) / "out"
        build_synthetic_dataset(data, object_names=[n for n, _ in SMOKE_OBJECTS],
                                env_splats=150_000, obj_splats=10_000)
        print(f"png writer: {'native' if _load_native() is not None else 'imageio'}", flush=True)
        rasterize_cuda.composite_tiles.launches = 0
        peg, n_static, host_static = run_scene(data, out, "smoke_static", "static", 10, 4, dev)
        _, n_dynamic, host_dynamic = run_scene(data, out, "smoke_dynamic", "dynamic", 2, 4, dev)
        gen_launches = rasterize_cuda.composite_tiles.launches
        n_frames = n_static + n_dynamic
        require((n_static, n_dynamic) == (40, 8), (n_static, n_dynamic))
        require(gen_launches == n_frames,
                f"composite_tiles launched {gen_launches} times for {n_frames} frames")
        print(f"main path: static {n_static} frames {n_static / host_static['wall_s']:.3f} frames/s, "
              f"dynamic {n_dynamic} frames {n_dynamic / host_dynamic['wall_s']:.3f} frames/s "
              f"(wall, incl. PNG writes; 640x480, all modalities) "
              f"readback_bytes={peg.last_render_stats['readback_bytes']} "
              f"fetch_stall_s={peg.last_render_stats['fetch_stall_s']} card={card}", flush=True)
        print(f"main path host: static {json.dumps(host_static)} dynamic {json.dumps(host_dynamic)} "
              f"cpus={len(os.sched_getaffinity(0))}", flush=True)
        stage_times(peg, card)
        # -- phase 6 ------------------------------------------------------------------------
        if args.profile:
            profile_main_path(data, out, dev, card)
        del peg
        torch.cuda.empty_cache()

        # -- phase 7: backward kernel vs plain ----------------------------------------------
        from pegasus_tpu_torch.ops.binning import bin_splats
        from pegasus_tpu_torch.ops.projection import project_gaussians

        bins = bin_splats(project_gaussians(train_box_cloud(dev), train_camera(dev)),
                          TRAIN_SIZE, TRAIN_SIZE)
        bwd_train = backward_vs_plain("train 150k box 512x512 K=1", bins, TRAIN_SIZE, TRAIN_SIZE, 1, card)
        bins = bin_splats(project_gaussians(scene_210k, cams["orbit"]), WIDTH, HEIGHT)
        bwd_210k = backward_vs_plain("210k orbit 640x480 K=7", bins, WIDTH, HEIGHT, max_objects, card)
        del bins, scene_210k
        stress = [long_segment_stress(dev, k, card) for k in (1, max_objects)]
        torch.cuda.empty_cache()

        # -- phase 8: the training main path ----------------------------------------------------
        train_launches = training_main_path(Path(tmp), dev, card, args.profile)

    print(json.dumps({"kernels": [{
        "name": "composite_tiles",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/composite_tiles.cu",
        "replaces": "pegasus_tpu/ops/rasterize_pallas.py:531",
        "launches": gen_launches + train_launches["forward"],
        "launches_generation": gen_launches,
        "launches_training": train_launches["forward"],
        "max_abs_err": max(max_abs_err, bwd_train["fwd_max_abs_err"], bwd_210k["fwd_max_abs_err"],
                           *(f for f, _ in stress)),
        "chunk_entries": CHUNK_ENTRIES,
        "items": timings["210k"]["hist"]["items"][CHUNK_ENTRIES],
        "items_1m": timings["1M"]["hist"]["items"][CHUNK_ENTRIES],
        "items_train": bwd_train["hist"]["items"][CHUNK_ENTRIES],
        "ms": timings["210k"]["ms"],
        "plain_ms": timings["210k"]["plain_ms"],
        "bound_ms": timings["210k"]["bound_ms"],
        "bound_by": timings["210k"]["bound_by"],
        "library_ms": None,
        "ms_1m": timings["1M"]["ms"],
        "plain_ms_1m": timings["1M"]["plain_ms"],
        "bound_ms_1m": timings["1M"]["bound_ms"],
        "ms_train": bwd_train["fwd_ms"],
        "plain_ms_train": bwd_train["fwd_plain_ms"],
        "bound_ms_train": bwd_train["fwd"][0],
    }, {
        "name": "composite_tiles_backward",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/composite_tiles_bwd.cu",
        "replaces": "pegasus_tpu/ops/pallas_vjp.py:105",
        "launches": train_launches["backward"],
        "max_abs_err": max(bwd_train["max_abs_err"], bwd_210k["max_abs_err"]),
        "max_abs_err_stress": max(b for _, b in stress),
        "chunk_entries": CHUNK_ENTRIES,
        "items": bwd_train["hist"]["items"][CHUNK_ENTRIES],
        "items_210k": bwd_210k["hist"]["items"][CHUNK_ENTRIES],
        "max_rel_err": max(bwd_train["max_rel_err"], bwd_210k["max_rel_err"]),
        "min_cosine": min(bwd_train["min_cosine"], bwd_210k["min_cosine"]),
        "ms": bwd_train["ms"],
        "plain_ms": bwd_train["plain_ms"],
        "bound_ms": bwd_train["bwd"][0],
        "bound_by": bwd_train["bwd"][1],
        "library_ms": None,
        "ms_210k": bwd_210k["ms"],
        "plain_ms_210k": bwd_210k["plain_ms"],
        "bound_ms_210k": bwd_210k["bwd"][0],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
