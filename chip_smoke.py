"""Smoke run of the PyTorch/CUDA port (``pegasus_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX.
Phases, each of which fails the run (nonzero exit) on any miss:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the tile compositor ``pegasus_tpu_torch/csrc/composite_tiles.cu``
   for sm_90a and print the build seconds and the compiler's report;
3. kernel vs plain: on the 210k-splat bench scene (150k plane + 6 boxes of
   10k, rng 7) and the 1M plane scene (820k plane + 6 boxes of 30k, rng 11),
   each at an orbit and a grazing camera, ``composite_tiles`` against
   ``composite_tiles_torch`` on the same bins: >= 60 dB per channel; both
   timed with CUDA events;
4. full render vs golden: ``rasterize`` against the torch golden
   compositor on the 210k scene, >= 40 dB per channel;
5. main path: the ``PEGASUS`` lifecycle replaying the committed trajectory
   ``tests/data/torch_smoke_trajectory.json`` over a synthetic dataset
   (150k-splat environment, six 10k-splat objects) at 640x480 with every
   modality: a static scene of 40 frames and a dynamic scene of 8.  The BOP
   tree is checked, and the kernel's launch count must equal the frames
   rendered.  Prints frames/s with the host's CPU time and load, and
   per-stage device times;
6. with ``--profile`` only: frames/s of both scenes with and without PNG
   writes, and a ``torch.profiler`` trace of the static scene (device busy
   share, kernel launches, the compositor's share of device time).

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
from pathlib import Path

REPO = Path(__file__).resolve().parent
TRAJECTORY = REPO / "tests" / "data" / "torch_smoke_trajectory.json"
MODALITIES = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]
WIDTH, HEIGHT = 640, 480
KERNEL_GATE_DB = 60.0
GOLDEN_GATE_DB = 40.0


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


def kernel_vs_plain(scenes, cams, max_objects):
    """Phase 3: composite_tiles against composite_tiles_torch on the same bins."""
    import torch

    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                                       composite_tiles_torch,
                                                       outputs_from_channels)

    max_abs_err, timings = 0.0, {}
    for sname, scene in scenes.items():
        for cname, cam in cams.items():
            proj = project_gaussians(scene, cam)
            bins = bin_splats(proj, WIDTH, HEIGHT)
            k_out = composite_tiles(bins, WIDTH, HEIGHT, max_objects)
            p_out = composite_tiles_torch(bins, WIDTH, HEIGHT, max_objects)
            torch.cuda.synchronize()
            require(torch.isfinite(k_out).all(), f"{sname}/{cname}: non-finite kernel output")
            err = float((k_out - p_out).abs().max())
            max_abs_err = max(max_abs_err, err)
            bg = (0.0, 0.0, 0.0)
            db = channel_psnr(outputs_from_channels(p_out, bg, max_objects),
                              outputs_from_channels(k_out, bg, max_objects))
            print(f"kernel vs plain {sname} {cname}: entries={bins.entry_splat.numel()} "
                  f"max_abs_err={err:.3e} dB={json.dumps(db)}", flush=True)
            bad = {k: v for k, v in db.items() if v < KERNEL_GATE_DB}
            require(not bad, f"{sname}/{cname}: kernel vs plain below {KERNEL_GATE_DB} dB: {bad}")
            if cname == "orbit":
                # plain, kernel, kernel, plain: one card, one call
                p1 = cuda_ms(lambda: composite_tiles_torch(bins, WIDTH, HEIGHT, max_objects), 2)
                k1 = cuda_ms(lambda: composite_tiles(bins, WIDTH, HEIGHT, max_objects), 20)
                k2 = cuda_ms(lambda: composite_tiles(bins, WIDTH, HEIGHT, max_objects), 20)
                p2 = cuda_ms(lambda: composite_tiles_torch(bins, WIDTH, HEIGHT, max_objects), 2)
                timings[sname] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                                  "runs_ms": [p1, k1, k2, p2]}
                print(f"composite time {sname} orbit: kernel {k1:.4f}/{k2:.4f} ms, "
                      f"plain {p1:.4f}/{p2:.4f} ms", flush=True)
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run phase 6 (frames/s with and without PNG writes, profiler trace)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from pegasus_tpu_torch.io.png import _load_native
    from pegasus_tpu_torch.ops import rasterize_cuda
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

    # -- phase 2: build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = rasterize_cuda.build_kernel()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.2f} s\n{log.strip()}", flush=True)

    # -- phase 3: kernel vs plain -------------------------------------------------
    max_objects = len(SMOKE_OBJECTS) + 1  # render_frame's K for six objects
    scenes = bench_scenes(dev)
    cams = bench_cameras(dev)
    max_abs_err, timings = kernel_vs_plain(scenes, cams, max_objects)

    # -- phase 4: full render vs golden ---------------------------------------------
    golden_parity(scenes["210k"], cams["orbit"], max_objects)
    del scenes
    torch.cuda.empty_cache()

    # -- phase 5: the main path ---------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="pegasus_smoke_") as tmp:
        data, out = Path(tmp) / "data", Path(tmp) / "out"
        build_synthetic_dataset(data, object_names=[n for n, _ in SMOKE_OBJECTS],
                                env_splats=150_000, obj_splats=10_000)
        print(f"png writer: {'native' if _load_native() is not None else 'imageio'}", flush=True)
        rasterize_cuda.composite_tiles.launches = 0
        peg, n_static, host_static = run_scene(data, out, "smoke_static", "static", 10, 4, dev)
        _, n_dynamic, host_dynamic = run_scene(data, out, "smoke_dynamic", "dynamic", 2, 4, dev)
        launches = rasterize_cuda.composite_tiles.launches
        n_frames = n_static + n_dynamic
        require((n_static, n_dynamic) == (40, 8), (n_static, n_dynamic))
        require(launches == n_frames, f"composite_tiles launched {launches} times for {n_frames} frames")
        print(f"main path: static {n_static} frames {n_static / host_static['wall_s']:.3f} frames/s, "
              f"dynamic {n_dynamic} frames {n_dynamic / host_dynamic['wall_s']:.3f} frames/s "
              f"(wall, incl. PNG writes; 640x480, all modalities) "
              f"readback_bytes={peg.last_render_stats['readback_bytes']} "
              f"fetch_stall_s={peg.last_render_stats['fetch_stall_s']} card={card}", flush=True)
        print(f"main path host: static {json.dumps(host_static)} dynamic {json.dumps(host_dynamic)} "
              f"cpus={len(os.sched_getaffinity(0))}", flush=True)
        stage_times(peg, card)
        if args.profile:
            profile_main_path(data, out, dev, card)

    print(json.dumps({"kernels": [{
        "name": "composite_tiles",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/composite_tiles.cu",
        "replaces": "pegasus_tpu/ops/rasterize_pallas.py:531",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": timings["210k"]["ms"],
        "plain_ms": timings["210k"]["plain_ms"],
        "ms_1m": timings["1M"]["ms"],
        "plain_ms_1m": timings["1M"]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
