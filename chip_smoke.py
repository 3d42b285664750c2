"""Smoke run of the PyTorch/CUDA port (``pegasus_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--from-phase N]

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX.
First it imports ``pegasus_tpu_torch`` and every subpackage and prints that
``torch.cuda.is_initialized()`` stayed False (it fails otherwise).
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
   every modality: a static scene of 40 frames and a dynamic scene of 8,
   each at ``frame_chunk`` 1 and 8 in the order 1, 8, 8, 1, every turn
   three runs (PNG writes on, off, and on under ``torch.profiler``), then
   at 3 once.  Every run's BOP tree is checked, the forward kernel launches
   and ``bin_splats`` reads the host once per chunk, and the trees at
   ``frame_chunk`` 1, 3 and 8 are byte-identical.  Prints per turn frames/s
   with and without PNG writes, launches and host reads per frame,
   ``fetch_stall_s`` and the trace's device busy share and kernel launches
   per frame; then the 300-frame static scene (10 cameras x 30 steps,
   ``GenerationConfig``'s default) at C = 8.  Then K1 at the chunk shape:
   one launch over 8 frames of the static scene bitwise equal to the 8
   frames' own launches and within phase 3's limits of the plain version
   on the chunk, likewise the long-segment stress tiles over 3 frames;
   timed beside the 8 single launches, with the chunk's bound.  Then per
   stage (project, bin, composite, decode + pack) at C = 1 and 8 the stream
   span between CUDA events (for a host-bound stage, the time the host
   takes to enqueue its launches) beside the profiler's device time;
6. (folded into phase 5 since the frame chunk: ``--profile`` now only adds
   ``simulate_variants(1000)`` to phase 9);
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
   kernel bitwise equal.  And at the training shape, the backward's
   scatter of per-entry gradients to splats (a segmented sum in a fixed
   order): bitwise repeatable over 5 runs, equal to a float64 sum on the
   host to 1e-6 of the largest sum; timed, and the kernels it launches
   named;
8. training main path: ``train_gaussian_splatting_wrapper`` on a synthetic
   COLMAP scene (28 views at 512x512 of the 150k-splat box, ground truth
   rendered by ``rasterize``, 40,000 seed points, capacity 200,000), 600
   iterations, so densification fires at 500 and 600.  Both kernels must
   launch once per iteration, the loss must fall, the alive count must
   exceed the seed count, both PLYs must load back and the PSNR over four
   training views must beat the seed cloud's.  A trainer built through
   the reference's positional form ``GSTrainer(config, None, W, H)``
   must take one ``train_step`` bitwise equal to the keyword form's from
   the same state.  Prints ms/step of whole
   ``train_step`` calls and peak device memory, and a ``torch.profiler``
   trace of 20 steps (device busy share, launches per step, each kernel's
   share of device time, and the device time of each stage of
   ``train_step`` from its ``record_function`` ranges, the backward's
   among them);
9. physics on the card: the smoke scene (``asphalt`` + the six
   ``SMOKE_OBJECTS``, ``init_bullet(random=False)``, 310 steps).  The
   captured step replayed 310 times must equal the same steps launched op
   by op on the card bitwise; each object's steps before its first contact
   (some spawn overlapping) must agree with a CPU run of the port to 1e-5;
   every state is finite, the environment never moves, no object sinks
   below z = -0.05 and, with the drop continued to 620 steps, every
   object's |linvel| < 0.15 at the last step (at step 310 one cup of this
   scene still slides).  Prints ms per step launched op by
   op and replayed, kernel launches per step (``torch.profiler``), seconds
   per scene, and scenes/s and peak device memory of
   ``simulate_variants(256)`` (with ``--profile`` also of 1000 variants);
10. generation main path with physics: ``run_generation`` at 640x480 with
   every modality over the 150k-splat environment and six 10k-splat
   objects, ``simulation_steps = 310``, 3-6 objects per scene: one static
   scene (10 cameras x 4 steps) and one dynamic scene (2 x 4) of one
   dataset.  ``check_bop_tree`` on both scenes, ``check_bop_dataset`` ok,
   two records in the stats JSONL, a further call resumes and renders
   nothing, and the forward kernel launches once per chunk of 8 frames
   (``config.frame_chunk``).  Prints per scene the physics / setup / render / finalize
   seconds and shares and frames/s;
11. scene variants: ``generate_scene_variants`` with V = 64 at 640x480 on a
   210k-splat template (150k plane + 6 flat boxes of 10k), drops of 600
   steps: one forward-kernel launch and one ``bin_splats`` host read per
   chunk of ``VARIANT_CHUNK`` = 8 variants (8), the outputs at
   ``VARIANT_CHUNK`` 8 and 1 (in turns 8, 1, 1, 8) bitwise equal, finite outputs, the gates
   of phase 9 on the recorded drops, except that 95 % of the 384 boxes (not
   every one) must lie still at the last step: six boxes dropped onto one
   spot pile up, and a pile sheds a box now and then.  Prints variants/s
   at each turn.

12. the splat-sharded render: ``rasterize_splat_sharded`` (backend "cuda")
   of the 1M plane scene at the orbit and the grazing camera, K = 7, on
   meshes of 1, 2, 4 and 8 lanes of the card: every channel >= 60 dB and
   max |diff| within phase 3's limit against the unsharded ``rasterize``,
   two renders bitwise equal, one forward-kernel launch per shard; >= 40 dB
   against the golden compositor at the 210k scene on 4 lanes; and
   ``rasterize_splat_sharded_batch`` on a (2, 4) mesh over two scenes equal
   to each scene's own 4-lane render.  Prints ms per frame at each lane
   count beside the unsharded time;
13. sharded generation: ``run_generation(mesh=)`` on a 4-lane mesh over the
   smoke dataset, 8 static scenes of 10 x 4 frames, then (resuming) 4
   dynamic scenes of 2 x 4: one ``simulate_batch`` per batch of 4 scenes (3
   calls), one forward-kernel launch per chunk of 8 frames (44 for 352
   frames), ``check_bop_tree`` and ``check_bop_dataset``, 12 stats records,
   a further call renders and drops nothing, the dynamic scenes' poses move
   between frames.  Prints seconds per scene and per batch stage, and
   scenes/s of 4 static scenes at 1, 2 and 4 lanes.  Then 2 static scenes of
   10 x 4 frames and 2 dynamic of 2 x 4 on the 4 lanes at ``frame_chunk`` 1,
   8, 8, 1 in turns: every turn's tree byte-identical to the first (all
   files but the stats and the config), one launch and one host read per
   chunk; prints per turn launches and host reads per frame and scenes/s;
14. the data-parallel train step at the training shape (150k-splat box,
   512x512, 40,000 seed points, capacity 200,000): 4 cameras on a 4-lane
   mesh against one ``_apply_grads`` of the mean of four single-view
   gradients (Adam's moments and the densify statistics within one train
   step's tolerances, the parameters too wherever |g| is above rounding),
   four launches of each kernel per step, 20 DP steps lower the loss.
   Prints ms per DP step beside 4 x the single step;
15. the full-roster dress rehearsal: nine environments (40,000 splats) and
   all 51 roster objects (4,000 splats) as synthetic assets, 16 static and
   4 dynamic scenes of 2 x 3 frames with 3-6 objects through
   ``run_generation(mesh=)`` on 4 lanes, the three camera modes in turn,
   one forward-kernel launch per scene (its 6 frames are one chunk);
   51 ``models_info`` entries, gt-info, NDDS, ``write_targets_bop19``,
   ``check_bop_dataset`` clean, and ``score_bop19`` with the written poses
   as estimates AR >= 0.99 (mssd and mspd exactly 1).  Prints the seconds of
   asset building, generation and scoring;
16. asset building and viewing at the training shape: (a) the
   hemispherical object recipe (``hemispherical_object_reconstruction``)
   over a scan of the training box laid out as ``object/<name>/up``, 600
   iterations on the card, with a stub ``colmap`` on PATH that installs the
   scan's sparse model (this machine has no COLMAP; SfM is stubbed): every
   stage recorded, both PLYs written, one backward launch per iteration and
   one forward launch per iteration and per evaluation render, the loss
   down and the PSNR over four views above the seed cloud's, a mesh of more
   than 100 faces named by the URDF, the cleaned cloud moved by the URDF's
   translation to 1e-5; prints each stage's seconds; (b) the SIBR wire
   viewer (``network_gui.gaussian_splatting_viewer``) in a thread serving 20
   orbit views at 640x480 to a client socket, each frame bitwise equal to
   ``rasterize`` of its camera, then ``viewer.render_rgb_u8`` of the same
   views; prints frames/s; (c) the static replayed scene with
   ``publish2gui=True`` answering 3 queued requests (one poll per chunk),
   byte-identical to a run without the GUI, forward launches = chunks
   written + frames served;
   (d) ``train_gaussian_splatting_wrapper(gui=True)`` for 20 iterations with
   a client asking for 3 frames, launches 20 + 3 forward and 20 backward,
   the parameters bitwise equal to a run without the GUI; (e) the
   reference-signature render wrappers over phase 5's dataset, equal to one
   ``render_frame`` / ``rasterize`` bitwise.

17. the renderer seam (a caller's renderer on the same kernels): (a) the
   210k orbit view at 640x480, K = 7, through ``rasterize_tiled`` at
   ``max_per_tile=1024`` (one K1 launch; the cap binds: the longest
   segment holds 5,738 entries), K1 on the capped bins against its plain
   version (>= 60 dB, phase 3's limits), the render equal to K1 on
   ``cap_bins`` bitwise, and at a cap of the longest segment bitwise equal
   to ``rasterize``; prints the entries dropped, the tiles capped, the
   render's ms beside ``rasterize``'s and K1's on capped beside full bins;
   (b) ``GSTrainer(cfg, None, 512, 512, max_per_tile=1024,
   backend="tiled")`` on the training box (150k splats, max 2,875 entries
   per tile) started from its colours and opacities perturbed: 20 steps
   with one K2′ and one K3 launch each and the loss falling, two steps from
   one state bitwise equal, one step's K3 rows against the plain version on
   the same capped bins (phase 7's gate), the sum to splats of capped bins
   against a float64 host sum of the kept entries; ms per step beside
   ``"auto"``'s, in turns; (c) ``PEGASUS(..., rasterize_fn=rasterize_tiled)``
   writes phase 5's static scene at C = 8 (one launch per frame, BOP tree
   and ``check_bop_dataset`` clean), and ``rasterize_fn=rasterize_reference``
   (the golden compositor, O(pixels x splats): a small dataset of a
   20k-splat environment and six 2k-splat objects, 8 frames, one chunk)
   writes files that match ``rasterize_fn=None``'s: JSON bytes equal, rgb
   >= 40 dB, masks <= 0.5 % of pixels, depth within 1 mm on >= 99 % of
   covered pixels.  The phase's launches count in the kernels line.

18. a crowded scene: one environment of 150,000 splats and 48 of the 51
   roster objects (4,000 splats each) per scene, K = 49.  (a)
   ``run_generation`` at 640x480 with every modality and ``frame_chunk``
   8 over one static scene (10 cameras x 4 steps) and one dynamic scene (2
   x 4), each with its own drop of 49 bodies: 6 forward launches for 48
   frames, ``check_bop_dataset`` clean, 48 objects per frame in
   ``scene_gt.json`` and 48 ``mask`` and 48 ``mask_visib`` PNGs per frame;
   prints frames/s, launches per frame and the seconds per stage.  (b) On a
   frame of the static scene, K1 and K3 at K = 49 and, with the ids folded
   into 1 .. 32, at K = 33 against their plain versions at phase 3's and
   phase 7's gates, each kernel twice bitwise equal; the same view at K = 7
   (ids folded into 1 .. 6) for the times, K1 and K3 beside K = 49 with
   their bounds; K1 at K = 64 on the 210k bench scene with its 60,000 box
   splats relabelled 1 + i % 63 against its plain version and twice
   bitwise; one K1 launch over 8 frames at K = 49 bitwise equal to the 8
   single-frame launches.  (c) The static drop replayed over small assets
   (20,000 + 48 x 500 splats), 4 frames written with
   ``rasterize_fn=rasterize_reference`` against the kernel's: the golden
   gates of phase 17.  The phase's generation launches count in the
   kernels line.

After phase 5 the compact-readback case runs the static replayed scene once
more with and without ``compact_readback`` (chunks of 8): every PNG and JSON
byte-identical; prints the bytes moved per frame both ways and frames/s.

``--from-phase N`` (N > 3) skips phases 3 to N - 1 while a later phase is
worked on (12: the build, the compact-readback case and phases 12-18; 16:
the build and phases 16-18; 17: the build and phases 17-18; 18: the build
and phase 18); such a run prints no result lines.  The last two lines of a
whole run are one JSON object for the kernels and one for the device; the
last line is ``{"ok": true, "device": {...}}``.
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
MAIN_PATH_CHUNKS = (1, 8, 8, 1)  # phase 5's frame_chunk turns
SIM_STEPS = 310  # the reference's drop length (GenerationConfig.simulation_steps)
SETTLE_STEPS = 620  # the smoke scene continued until every object lies still
PHYSICS_VARIANTS = 256  # simulate_variants' batch in phase 9
PHYSICS_VARIANTS_LARGE = 1000  # and with --profile: BASELINE.json's throughput config
SCENE_VARIANTS = 64  # generate_scene_variants' V in phase 11
VARIANT_STEPS = 600  # their drop length: six boxes land on each other and need longer to settle
VARIANT_REST_SHARE = 0.95  # of 64 x 6 boxes: a pile sheds a box now and then, long after the rest lie still
PRE_CONTACT_ATOL = 1e-5  # card vs CPU, steps before first contact
SINK_LIMIT = -0.05  # no object's origin below this z, any step
REST_LINVEL = 0.15  # every object's |linvel| at the last step

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


def bench_scenes(device, names=("210k", "1M")):
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

    makers = {"210k": lambda: scene(7, 150_000, 10_000), "1M": lambda: scene(11, 820_000, 30_000)}
    return {name: makers[name]() for name in names}


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


def check_bop_tree(out_root: Path, name: str, scene_id: int, n_frames: int, n_obj: int,
                   n_models: int | None = None):
    """The BOP tree of one scene: JSONs with one entry per frame and one PNG
    per modality per frame; images non-trivial.  ``n_models``: the models
    exported for the dataset, when a scene holds fewer objects than that."""
    import numpy as np

    base = out_root / name
    scene = base / "train" / f"{scene_id:06d}"
    require((base / "camera.json").exists(), "camera.json missing")
    minfo = json.loads((base / "models" / "models_info.json").read_text())
    require(len(minfo) == (n_obj if n_models is None else n_models), minfo.keys())
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
                  n_interp: int, device, compact_readback: bool = False,
                  publish2gui: bool = False, frame_chunk: int = 8, rasterize_fn=None):
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
        seed=3, QUIET=True, device=device, compact_readback=compact_readback,
        publish2gui=publish2gui, frame_chunk=frame_chunk, rasterize_fn=rasterize_fn,
    )
    peg.physics_file = str(TRAJECTORY)
    peg.selected_env_name = SMOKE_ENV[0]
    peg.init(name, 1)
    peg.init_start_position()
    return peg


LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def trace_summary(prof) -> dict:
    """Device ms (device-side rows of ``key_averages``), kernel launches and
    the forward kernel's device ms of a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType

    avgs = prof.key_averages()
    # device-side rows only: a CPU op's self device time repeats its kernels'
    device_rows = [a for a in avgs if a.device_type == DeviceType.CUDA]
    device_ms = sum(a.self_device_time_total for a in device_rows) / 1e3
    require(device_ms > 0, "the profiler recorded no device time")
    return {"device_ms": device_ms,
            "launches": sum(a.count for a in avgs if a.key in LAUNCH_KEYS),
            "composite_ms": sum(a.self_device_time_total for a in device_rows
                                if "composite_tiles" in a.key) / 1e3}


def run_scene(data: Path, out: Path, name: str, mode: str, num_cameras: int,
              n_interp: int, device, save_bop: bool = True, frame_chunk: int = 8,
              trace: bool = False, rasterize_fn=None):
    """Generate and save one scene; returns (pegasus, frames, host stats).

    Host stats: wall seconds of ``generate_dataset`` + ``save2bop``, the
    process's CPU seconds over the same span (all threads, the PNG writer
    pool included), the 1-minute load average at its start, and the forward
    kernel's launches and ``bin_splats``' host reads in the run.  With
    ``trace`` the run is traced by ``torch.profiler`` (``trace_summary``
    under "trace")."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.testing import SMOKE_OBJECTS

    peg = scene_pegasus(data, out, name, mode, num_cameras, n_interp, device,
                        frame_chunk=frame_chunk, rasterize_fn=rasterize_fn)
    load = os.getloadavg()[0]
    launches, reads = rasterize_cuda.composite_tiles.launches, bin_splats.host_reads
    tracer = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace
              else contextlib.nullcontext())
    with tracer as prof:
        t0, c0 = time.perf_counter(), time.process_time()
        peg.generate_dataset(MODALITIES, save_bop=save_bop, save_video=False)
        peg.save2bop()
        torch.cuda.synchronize()
        host = {"wall_s": time.perf_counter() - t0, "cpu_s": time.process_time() - c0,
                "loadavg_1m": load}
    host["launches"] = rasterize_cuda.composite_tiles.launches - launches
    host["host_reads"] = bin_splats.host_reads - reads
    host["fetch_stall_s"] = peg.last_render_stats["fetch_stall_s"]
    if trace:
        host["trace"] = trace_summary(prof)
    n_frames = len(peg.viewport_cam_list)
    if save_bop:
        check_bop_tree(out, name, 1, n_frames, len(SMOKE_OBJECTS))
    return peg, n_frames, host


def same_trees(a: Path, b: Path, skip: tuple = ()) -> list:
    """Files of scene tree ``a`` that differ from ``b`` byte for byte (or
    are missing from it), files named in ``skip`` left out; fails if ``b``
    holds other files."""
    def files_of(root):
        return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file() and p.name not in skip)

    files = files_of(a)
    require(files and files == files_of(b), f"{a.name} and {b.name} hold other files")
    return [str(f) for f in files if (a / f).read_bytes() != (b / f).read_bytes()]


def main_path_phase(data: Path, out: Path, device, card: str) -> dict:
    """Phase 5: the static (40 frames) and dynamic (8 frames) scene at
    ``frame_chunk`` 1 and 8 in the order 1, 8, 8, 1, each turn three runs:
    PNG writes on, off, and on under ``torch.profiler``; then C = 3 once.
    Every run: K1 launches and ``bin_splats`` host reads = its chunks; the
    trees at C = 1, 3 and 8 byte-identical.  Then the 300-frame static scene
    at C = 8.  Returns {"frames", "chunks"} of all these runs."""
    import torch

    total = {"frames": 0, "chunks": 0}
    for mode, n_cams in (("static", 10), ("dynamic", 2)):
        trees = {}
        for turn, c in enumerate(MAIN_PATH_CHUNKS + (3,)):
            runs = {}
            for kind, save_bop, trace in (("png", True, False), ("nopng", False, False),
                                          ("trace", True, True)):
                if c == 3 and kind != "png":
                    continue
                name = f"smoke_{mode}_c{c}_{turn}_{kind}"
                _, n, host = run_scene(data, out, name, mode, n_cams, 4, device, save_bop=save_bop,
                                       frame_chunk=c, trace=trace)
                chunks = -(-n // c)
                require(n == (40 if mode == "static" else 8), (mode, n))
                require(host["launches"] == chunks and host["host_reads"] == chunks,
                        f"{name}: {host['launches']} launches, {host['host_reads']} host reads "
                        f"for {chunks} chunks")
                total["frames"] += n
                total["chunks"] += chunks
                runs[kind] = host
                if kind == "png":
                    trees.setdefault(c, out / name / "train" / "000001")
            if c == 3:
                continue
            tr = runs["trace"]["trace"]
            wall_ms = runs["trace"]["wall_s"] * 1e3
            print(f"main path {mode} C={c} turn {turn}: {n} frames, "
                  f"{n / runs['png']['wall_s']:.3f} frames/s with PNG writes, "
                  f"{n / runs['nopng']['wall_s']:.3f} without; K1 launches/frame "
                  f"{runs['png']['launches'] / n:.4f}, bin_splats host reads/frame "
                  f"{runs['png']['host_reads'] / n:.4f}, fetch_stall_s {runs['png']['fetch_stall_s']}; "
                  f"trace (PNG writes on): "
                  f"wall {wall_ms:.3f} ms, device {tr['device_ms']:.3f} ms, busy share "
                  f"{tr['device_ms'] / wall_ms:.4f}, {tr['launches'] / n:.2f} kernel launches/frame, "
                  f"composite_tiles {tr['composite_ms']:.3f} ms; host {json.dumps(runs['png'])} "
                  f"card={card}", flush=True)
        for c in (3, 8):
            differ = same_trees(trees[1], trees[c])
            require(not differ, f"{mode}: frame_chunk={c} wrote other bytes than 1: {differ[:5]}")
        print(f"main path {mode}: the trees at frame_chunk 1, 3 and 8 byte-identical "
              f"({sum(1 for p in trees[1].rglob('*') if p.is_file())} files)", flush=True)
        torch.cuda.empty_cache()

    # GenerationConfig's default scene: 10 cameras x 30 interpolation steps
    _, n, host = run_scene(data, out, "smoke_static_300", "static", 10, 30, device, frame_chunk=8)
    require(n == 300, n)
    require(host["launches"] == host["host_reads"] == 300 // 8 + 1, host)
    total["frames"] += n
    total["chunks"] += host["launches"]
    print(f"main path static 300 frames C=8: {n / host['wall_s']:.3f} frames/s with PNG writes, "
          f"K1 launches/frame {host['launches'] / n:.4f}, host reads/frame {host['host_reads'] / n:.4f}, "
          f"fetch_stall_s {host['fetch_stall_s']}; host {json.dumps(host)} card={card}",
          flush=True)
    return total


def stage_pass(scene, cams, colors, k: int, chunk: int, background, events: bool):
    """The static scene's frames through the generation stages in chunks
    of ``chunk``, each stage in a ``record_function`` range ``stage/<name>``
    and, with ``events``, between CUDA events; returns {stage: ms of
    stream span summed over the chunks}."""
    import torch
    from torch.profiler import record_function

    from pegasus_tpu_torch.camera import CameraBatch
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import composite_tiles, outputs_from_channels
    from pegasus_tpu_torch.ops.render import decode_modalities, encode_frame, pack_frame_bytes

    batch = CameraBatch.stack(cams)
    names = ("project", "bin", "composite", "pack")
    total = dict.fromkeys(names, 0.0)
    h, w = batch.height, batch.width
    for lo in range(0, len(cams), chunk):
        part = batch[lo : lo + chunk]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)] if events else None
        if events:
            ev[0].record()
        with record_function("stage/project"):
            proj = project_gaussians(scene, part)
        if events:
            ev[1].record()
        with record_function("stage/bin"):
            bins = bin_splats(proj, w, h)
        if events:
            ev[2].record()
        with record_function("stage/composite"):
            out = composite_tiles(bins, w, h, k).reshape(len(part), h, w, -1)
        if events:
            ev[3].record()
        with record_function("stage/pack"):
            frame = decode_modalities(outputs_from_channels(out, background, k), colors)
            pack_frame_bytes(encode_frame(frame))
        if events:
            ev[4].record()
            ev[4].synchronize()
            for i, n in enumerate(names):
                total[n] += ev[i].elapsed_time(ev[i + 1])
    return total


def stage_times(data: Path, out: Path, device, card: str):
    """Per-stage time of the static scene's frames at C = 1 and C = 8: the
    stream span between CUDA events around each stage (for a host-bound
    stage, the time the host takes to enqueue its launches) beside the
    profiler's device time of each stage's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.scene.composition import pose_scene

    peg = scene_pegasus(data, out, "stages", "static", 10, 4, device)
    k = len(peg.semantic_colors) + 1
    poses = peg._body_poses_at(peg._initial_step)
    t_pose = cuda_ms(lambda: pose_scene(peg.template, *poses), 5)
    scene = pose_scene(peg.template, *poses)
    cams, n = peg.viewport_cam_list, len(peg.viewport_cam_list)
    args = (scene, cams, peg._semantic_colors_dev, k)
    for c in (1, 8):
        stage_pass(*args, c, peg.background, events=False)  # warm
        span = stage_pass(*args, c, peg.background, events=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stage_pass(*args, c, peg.background, events=False)
            torch.cuda.synchronize()
        device_ms, unassigned = stage_split(prof, "stage/")
        span = {s: round(v / n, 4) for s, v in span.items()}
        dev = {s: round(v / n, 4) for s, v in device_ms.items()}
        print(f"stage ms/frame (static scene, {n} frames, C={c}, 210k splats, {WIDTH}x{HEIGHT}): "
              f"stream span {json.dumps(span)}; profiler device time {json.dumps(dev)} "
              f"(outside any stage {unassigned / n:.4f}); pose once per scene {t_pose:.4f} ms "
              f"card={card}", flush=True)
    peg.pegasus_dataset.close()


def chunk_kernel_check(data: Path, out: Path, device, card: str) -> dict:
    """K1 at the main path's chunk shape: one launch over 8 frames of the
    static scene bitwise equal to the 8 frames' own launches, and within
    ``forward_vs_plain``'s limits of the plain version on the chunk; the
    long-segment stress tiles stacked over 3 frames likewise.  Times the
    chunk launch (plain, kernel, kernel, plain) beside the 8 single launches
    and the chunk's bound.  Run outside the main path's launch count."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.camera import CameraBatch
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import (CHUNK_ENTRIES, composite_tiles,
                                                       composite_tiles_torch)
    from pegasus_tpu_torch.scene.composition import pose_scene
    from pegasus_tpu_torch.testing import make_tile_pileup

    peg = scene_pegasus(data, out, "chunk_kernel", "static", 10, 4, device)
    k = len(peg.semantic_colors) + 1
    drop = peg.trajectory.times_t
    require(bool(np.isfinite(drop).all()) and float(np.abs(drop).max()) < 2.0,
            f"the static drop left the scene: max |position| {float(np.abs(drop).max())} m")
    scene = pose_scene(peg.template, *peg._body_poses_at(peg._initial_step))
    cams = peg.viewport_cam_list[:8]
    bins = bin_splats(project_gaussians(scene, CameraBatch.stack(cams)), WIDTH, HEIGHT)
    frames = [bin_splats(project_gaussians(scene, cam), WIDTH, HEIGHT) for cam in cams]
    chunk = composite_tiles(bins, WIDTH, HEIGHT, k)
    for f, one in enumerate(frames):
        require(torch.equal(chunk[f], composite_tiles(one, WIDTH, HEIGHT, k)),
                f"chunk frame {f} differs from its own launch")
    err = forward_vs_plain("chunk of 8 static frames", bins, WIDTH, HEIGHT, k)
    ms, plain_ms, runs = time_pair(lambda: composite_tiles(bins, WIDTH, HEIGHT, k),
                                   lambda: composite_tiles_torch(bins, WIDTH, HEIGHT, k), n_plain=1)
    frames_ms = cuda_ms(lambda: [composite_tiles(b, WIDTH, HEIGHT, k) for b in frames], 20)
    bound_ms, bound_by = compositor_bounds(bins, WIDTH, HEIGHT, k)["fwd"]
    frame_bounds = sum(compositor_bounds(b, WIDTH, HEIGHT, k)["fwd"][0] for b in frames)
    print(f"chunk kernel 8 frames {WIDTH}x{HEIGHT} K={k}: entries={bins.entry_splat.numel()}, "
          f"bitwise equal to 8 single launches; one launch {runs[1]:.4f}/{runs[2]:.4f} ms, 8 single "
          f"launches {frames_ms:.4f} ms, plain {runs[0]:.4f}/{runs[3]:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}; the 8 frames' bounds sum to {frame_bounds:.4f}) card={card}", flush=True)

    c, w, h = CHUNK_ENTRIES, 128, 64
    piles = [make_tile_pileup(np.random.default_rng(5 + f),
                              {0: 10 * c + 37, 1: c - 1, 2: c, 3: c + 1, 12: 40}, w, h, k, device=device)
             for f in range(3)]
    stacked = ProjectedGaussians(*(torch.stack([getattr(p, name) for p in piles])
                                   for name in ProjectedGaussians._fields))
    stress = bin_splats(stacked, w, h)
    stress_err = forward_vs_plain(f"stress K={k} over 3 frames", stress, w, h, k)
    out3 = composite_tiles(stress, w, h, k)
    for f in range(3):
        one = bin_splats(ProjectedGaussians(*(x[f] for x in stacked)), w, h)
        require(torch.equal(out3[f], composite_tiles(one, w, h, k)), f"stress frame {f} differs")
    require(torch.equal(out3, composite_tiles(stress, w, h, k)), "two stress chunk launches differ")
    print(f"chunk kernel stress K={k} over 3 frames: bitwise equal to 3 single launches and "
          f"repeatable, max_abs_err {stress_err:.3e} card={card}", flush=True)
    peg.pegasus_dataset.close()
    return {"ms": ms, "plain_ms": plain_ms, "frames_ms": frames_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": max(err, stress_err), "frames": len(cams)}


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
    of one frame's or one chunk's bins: the alpha tests and the compositing work the
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
    # entries in segments: all of them, or those cap_bins kept
    n, m, n_tiles = bins.params.shape[1], int(bins.tile_count.sum()), bins.tile_start.numel()
    inputs = 4 * (12 * n + m + 2 * n_tiles)
    pixels = bins.n_frames * height * width
    image = 4 * pixels * (5 + 3 * k + 2)
    per_pixel = pixels * (2 * (5 + k) + 2 * k + 2)
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
    and partials: per gradient row over the entries in segments (all of
    them, or those ``cap_bins`` kept; K3 leaves the others unwritten),
    cosine >= 0.99999 and max |diff| <= 1e-4 x max |gradient|.  Returns
    [(cosine, max |diff|, max |g|)]."""
    import torch

    from pegasus_tpu_torch.ops.composite_vjp import (composite_tiles_backward,
                                                     composite_tiles_backward_torch)

    got = composite_tiles_backward(bins, grad, out, partials, width, height, k, chunk_entries)
    want = composite_tiles_backward_torch(bins, grad, out, partials, width, height, k,
                                          chunk_entries=chunk_entries)
    torch.cuda.synchronize()
    n = int(bins.tile_count.sum())
    got, want = got[:, :n], want[:, :n]
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


def scatter_to_splats(label, bins, card) -> dict:
    """Phase 7: the backward's scatter of per-entry gradients to splats
    (``entry_grads_to_splats``, a segmented sum in a fixed order) on seeded
    rows at one shape: bitwise repeatable over 5 runs, equal to a float64
    sum on the host to 1e-6 of the largest |sum|; timed, and the kernels it
    launches named."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.ops.composite_vjp import N_GRAD, entry_grads_to_splats

    dev = bins.params.device
    g = torch.randn((N_GRAD, bins.entry_splat.numel()),
                    generator=torch.Generator().manual_seed(11)).to(dev)
    runs = [entry_grads_to_splats(bins, g) for _ in range(5)]
    torch.cuda.synchronize()
    require(all(torch.equal(runs[0], x) for x in runs[1:]), f"{label}: the segmented sum differs between runs")
    ref = torch.zeros(N_GRAD, bins.params.shape[1], dtype=torch.float64)
    ref.index_add_(1, bins.entry_splat.cpu().long(), g.cpu().double())
    diff = float((runs[0][:N_GRAD].cpu().double() - ref).abs().max())
    scale = float(ref.abs().max())
    require(diff <= 1e-6 * scale, f"{label}: segmented sum vs float64 host sum {diff} (max |sum| {scale})")
    ms = cuda_ms(lambda: entry_grads_to_splats(bins, g), 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        entry_grads_to_splats(bins, g)
        torch.cuda.synchronize()
    kernels = sorted({a.key for a in prof.key_averages() if a.device_type == DeviceType.CUDA})
    print(f"scatter to splats {label}: entries={bins.entry_splat.numel()} segmented sum {ms:.4f} ms, "
          f"bitwise repeatable over 5 runs, max|diff| {diff:.3e} against a float64 host sum of "
          f"max|sum| {scale:.3e}; launches {kernels} card={card}", flush=True)
    return {"ms": ms, "max_abs_err": diff}


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
    from pegasus_tpu_torch.testing import write_colmap_scan

    write_colmap_scan(root, train_box_cloud(device), TRAIN_SIZE, n_images=28, fov_deg=55.0,
                      radius=0.9, n_seeds=SEED_POINTS, seed=3)


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


def train_state_differences(a, b) -> list:
    """The fields of two ``TrainState``s that are not bitwise equal."""
    import dataclasses

    import torch

    differ = [f"cloud.{f.name}" for f in dataclasses.fields(a.cloud)
              if not torch.equal(getattr(a.cloud, f.name), getattr(b.cloud, f.name))]
    for name in ("mu", "nu"):
        differ += [f"{name}.{g}" for g in getattr(a, name)
                   if not torch.equal(getattr(a, name)[g], getattr(b, name)[g])]
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            differ.append(name)
    differ += [n for n in ("count", "step", "spatial_lr_scale") if getattr(a, n) != getattr(b, n)]
    return differ


def port_imports_leave_cuda_alone() -> int:
    """Import ``pegasus_tpu_torch`` and every subpackage; CUDA must stay
    uninitialised (no kernel built, no library loaded, no context made).
    Returns the number of packages imported."""
    import importlib
    import pkgutil

    import torch

    import pegasus_tpu_torch

    packages = [pegasus_tpu_torch] + [
        importlib.import_module(m.name)
        for m in pkgutil.walk_packages(pegasus_tpu_torch.__path__, "pegasus_tpu_torch.") if m.ispkg]
    require(not torch.cuda.is_initialized(), "importing the port initialised CUDA")
    return len(packages)


def profile_training(trainer, state, cams, gts, card, steps: int = 20):
    """A torch.profiler trace of ``steps`` training steps, with the device
    time of each of ``train_step``'s stages (the backward's among them);
    and the host cost of one of its ``record_function`` ranges with no
    profiler on."""
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
    launches = sum(a.count for a in avgs if a.key in LAUNCH_KEYS)
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


def training_main_path(tmp: Path, device, card: str):
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
    # the reference's positional form binds as the keyword form: one step of each, bitwise
    positional = GSTrainer(config, None, scene["width"], scene["height"], device=device)
    require((positional.width, positional.height) == (trainer.width, trainer.height),
            (positional.width, positional.height))
    by_keyword, _ = trainer.train_step(state, step_cams[5], step_gts[5])
    by_position, _ = positional.train_step(state, step_cams[5], step_gts[5])
    differ = train_state_differences(by_keyword, by_position)
    require(not differ, f"GSTrainer(config, None, W, H) stepped otherwise than the keyword form: {differ}")
    print(f"GSTrainer(config, None, {scene['width']}, {scene['height']}): one train_step bitwise "
          f"equal to the keyword form's (every parameter, moment and statistic) card={card}", flush=True)
    del by_keyword, by_position
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(20):
        state, _ = trainer.train_step(state, step_cams[i], step_gts[i])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(f"train_step: {step_ms:.3f} ms/step (host clock over 20 steps ending in synchronize, "
          f"{int(state.cloud.alive.sum())} alive of {capacity}, {TRAIN_SIZE}x{TRAIN_SIZE}) card={card}",
          flush=True)
    profile_training(trainer, state, step_cams, step_gts, card)
    return launches


def smoke_assets(data: Path):
    """The smoke dataset's environment and its six objects as ``Asset``s."""
    from pegasus_tpu_torch.assets.registry import Asset
    from pegasus_tpu_torch.testing import SMOKE_ENV, SMOKE_OBJECTS

    env = Asset(OBJECT_NAME=SMOKE_ENV[0], ID=SMOKE_ENV[1], TYPE="environment",
                dataset_path=str(data))
    return env, [Asset(OBJECT_NAME=n, ID=i, dataset_path=str(data)) for n, i in SMOKE_OBJECTS]


def rest_gates(label, pos, rot, linvel, start_pos, start_rot, dynamic, rest_share: float = 1.0):
    """Gates on a recorded drop.  pos / rot / linvel: [..., T, B, 3 or 4]
    with the step axis third from last; start_pos / start_rot: [..., B, 3 or
    4]; dynamic: [B] bool.  Every state finite, the static bodies where they
    started at every step, no dynamic body below SINK_LIMIT, and at the last
    step at least ``rest_share`` of the dynamic bodies (all of them by
    default) slower than REST_LINVEL.  Returns (lowest z, largest last-step
    |linvel|, share at rest)."""
    import torch

    require(all(bool(torch.isfinite(x).all()) for x in (pos, rot, linvel)), f"{label}: non-finite state")
    static = ~dynamic
    require(torch.equal(pos[..., static, :], start_pos[..., None, static, :].expand_as(pos[..., static, :]))
            and torch.equal(rot[..., static, :], start_rot[..., None, static, :].expand_as(rot[..., static, :])),
            f"{label}: a static body moved")
    low = float(pos[..., dynamic, 2].min())
    require(low > SINK_LIMIT, f"{label}: an object sank to z = {low}")
    speeds = torch.linalg.vector_norm(linvel[..., -1, dynamic, :], dim=-1)
    speed, share = float(speeds.max()), float((speeds < REST_LINVEL).float().mean())
    require(share >= rest_share,
            f"{label}: {share:.4f} of the objects at rest at the last step (largest |linvel| {speed})")
    return low, speed, share


def physics_on_card(data: Path, out: Path, device, card: str, large_batch: bool) -> None:
    """Phase 9: the smoke scene's drop on the card, replayed against op by
    op (bitwise), against the CPU before first contact, the rest gates, and
    the timings of one scene and of ``simulate_variants``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pegasus_tpu_torch.pegasus import PEGASUS
    from pegasus_tpu_torch.physics import rigid_body as rb

    env, objs = smoke_assets(data)

    def dropped(dev, name):
        peg = PEGASUS(
            dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
            gs_env_list=[env], gs_object_list=objs, mode="static", render_height=HEIGHT,
            render_width=WIDTH, simulation_steps=SIM_STEPS, dataset_base_path=str(out), seed=3,
            QUIET=True, device=dev,
        )
        t0 = time.perf_counter()
        peg.init_bullet([env], objs, name, 1, len(objs), len(objs), random=False)
        return peg, time.perf_counter() - t0

    peg, first_s = dropped(device, "smoke_physics")  # captures the step
    _, scene_s = dropped(device, "smoke_physics_again")  # replays the cached capture
    require(peg.trajectory.num_steps == SIM_STEPS and peg.trajectory.num_bodies == 1 + len(objs),
            (peg.trajectory.num_steps, peg.trajectory.num_bodies))
    engine = peg.py_engine
    params, state0 = engine._build()
    kw = dict(n_steps=SIM_STEPS, dt=engine.dt, gravity=engine.gravity,
              heightfield=engine.heightfield, device=device)
    batch0 = rb.RigidBodyState(*(t[None] for t in (state0.pos, state0.rot, state0.linvel, state0.angvel)))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3 / SIM_STEPS

    (replayed, _), replay_ms = timed(lambda: rb.simulate_batch(params, batch0, **kw))
    (eager, _), eager_ms = timed(lambda: rb.simulate_batch_eager(params, batch0, **kw))
    (replayed2, _), replay_ms2 = timed(lambda: rb.simulate_batch(params, batch0, **kw))
    for a, b in ((replayed, eager), (replayed2, eager)):
        require(torch.equal(a.packed(), b.packed()),
                f"replayed and op-by-op steps differ: max |diff| {float((a.packed() - b.packed()).abs().max())}")
    recorded = torch.tensor(peg.trajectory.times_t, dtype=torch.float32).transpose(0, 1)
    require(torch.equal(recorded, replayed.pos[0, :, :recorded.shape[1]].cpu()),
            "init_bullet's trajectory is not the replayed drop")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rb.simulate_batch_eager(params, batch0, **{**kw, "n_steps": 5})
        torch.cuda.synchronize()
    launches = sum(a.count for a in prof.key_averages() if a.key in LAUNCH_KEYS) / 5

    dynamic = (params.inv_mass > 0) & params.body_mask
    # the rest gates, on the same drop continued to SETTLE_STEPS (the graph
    # replays for as long as asked): at step 310 of this scene one cup still
    # slides at 0.70 m/s, in the reference's recorded trajectory too
    (settled, _), _ = timed(lambda: rb.simulate_batch(params, batch0, **{**kw, "n_steps": SETTLE_STEPS}))
    require(torch.equal(settled.packed()[:, :SIM_STEPS], replayed.packed()), "the longer drop starts differently")
    low, speed, _ = rest_gates("physics", settled.pos[0], settled.rot[0], settled.linvel[0],
                               state0.pos, state0.rot, dynamic)
    speed_310 = float(torch.linalg.vector_norm(replayed.linvel[0, -1, dynamic], dim=-1).max())

    # the same drop on the CPU, op by op.  Objects that spawn overlapping
    # are in contact from step 0; an object still in free fall has no
    # angular and no sideways velocity, and until its first contact the
    # card must agree with the CPU closely
    t0 = time.perf_counter()
    cpu, _ = rb.simulate_batch_eager(params.to("cpu"), batch0.to("cpu"),
                                     **{**kw, "device": "cpu", "heightfield": engine.heightfield.to("cpu")})
    cpu_s = time.perf_counter() - t0
    touched = (cpu.angvel[0].abs().amax(dim=-1) > 0) | (cpu.linvel[0][..., :2].abs().amax(dim=-1) > 0)  # [T, B]
    free_steps = [int(torch.nonzero(touched[:, b])[0]) if bool(touched[:, b].any()) else SIM_STEPS
                  for b in range(1, 1 + len(objs))]
    require(max(free_steps) >= 20, f"no object falls freely for 20 steps: {free_steps}")
    pre_err = max(
        float((getattr(replayed, f)[0, :n, b].cpu() - getattr(cpu, f)[0, :n, b]).abs().max())
        for f in ("pos", "rot", "linvel", "angvel") for b, n in enumerate(free_steps, start=1) if n > 0)
    require(pre_err <= PRE_CONTACT_ATOL, f"card vs CPU before contact: {pre_err}")
    step_err = float((replayed.packed()[0, 0].cpu() - cpu.packed()[0, 0]).abs().max())
    end_err = float((replayed.pos[0, -1].cpu() - cpu.pos[0, -1]).abs().max())
    print(f"physics: {SIM_STEPS} steps, {1 + len(objs)} bodies of {params.inv_mass.shape[0]} slots, "
          f"replayed == op by op bitwise; {replay_ms:.4f} / {replay_ms2:.4f} ms/step replayed, "
          f"{eager_ms:.4f} ms/step op by op, {launches:.1f} kernel launches per step op by op; "
          f"init_bullet {first_s:.3f} s with the capture, {scene_s:.3f} s per scene after; "
          f"card vs CPU max |diff| {pre_err:.3e} over the free-fall steps {free_steps} of the six objects "
          f"(first step, with contacts, {step_err:.3e}; last step's positions {end_err:.3e}; CPU run "
          f"{cpu_s:.2f} s); lowest z {low:.4f}, largest |linvel| {speed_310:.4f} at step {SIM_STEPS} and "
          f"{speed:.4f} at step {SETTLE_STEPS} card={card}", flush=True)

    # simulate_variants: V re-drops of that scene as one program
    import numpy as np

    n_obj = len(objs)
    for n_variants in (PHYSICS_VARIANTS,) + ((PHYSICS_VARIANTS_LARGE,) if large_batch else ()):
        # the capturing call allocates what one V-wide step needs; later
        # calls replay inside the graph's own pool, which the allocator's
        # peak of allocated bytes no longer sees, so the peak is read over
        # the capture
        rb.clear_step_programs()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine.simulate_variants(n_variants, seed=0)  # captures the V-wide step
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        reserved_gib = torch.cuda.memory_reserved() / 2**30
        t0 = time.perf_counter()
        v_pos, v_rot = engine.simulate_variants(n_variants, seed=1)
        v_s = time.perf_counter() - t0
        require(v_pos.shape == (n_variants, SIM_STEPS, params.inv_mass.shape[0], 3), v_pos.shape)
        require(np.isfinite(v_pos).all() and np.isfinite(v_rot).all(), "non-finite variant trajectory")
        require(v_pos[:, :, 1:1 + n_obj, 2].min() > SINK_LIMIT, "a variant's object sank")
        require(np.abs(v_pos[:, :, 0]).max() == 0.0, "a variant's environment moved")
        print(f"simulate_variants({n_variants}): {v_s:.3f} s ({n_variants / v_s:.2f} scenes/s, "
              f"{1e3 * v_s / SIM_STEPS:.4f} ms/step, host copies of the trajectories included), "
              f"peak device memory {peak_gib:.3f} GiB allocated over the capturing call, "
              f"{reserved_gib:.3f} GiB reserved after it card={card}", flush=True)
    rb.clear_step_programs()
    torch.cuda.empty_cache()


def generation_with_physics(data: Path, out: Path, device, card: str) -> int:
    """Phase 10: ``run_generation`` drops, renders and writes one static and
    one dynamic scene of one dataset (``config.frame_chunk`` 8: 5 + 1
    chunks); returns the forward kernel's launches."""
    from pegasus_tpu_torch.config import GenerationConfig
    from pegasus_tpu_torch.eval import check_bop_dataset
    from pegasus_tpu_torch.generate import run_generation
    from pegasus_tpu_torch.ops import rasterize_cuda

    env, objs = smoke_assets(data)
    name = "smoke_generate"

    def config(mode, num_scenes, num_cameras, seed):
        return GenerationConfig(
            dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
            dataset_base_path=str(out), dataset_name=name, num_scenes=num_scenes,
            min_num_objects=3, max_num_objects=6, mode=mode, render_width=WIDTH,
            render_height=HEIGHT, num_cameras=num_cameras, num_camera_interpolation_steps=4,
            camera_trajectory_mode="random", render_data_points=list(MODALITIES),
            simulation_steps=SIM_STEPS, save_video=False, seed=seed,
        )

    rasterize_cuda.composite_tiles.launches = 0
    # scene 1 static; the second call resumes past it and adds scene 2, dynamic
    static = run_generation(config("static", 1, 10, 3), [env], objs, device=device)
    dynamic = run_generation(config("dynamic", 2, 2, 4), [env], objs, device=device)
    launches = rasterize_cuda.composite_tiles.launches
    records = static.records + dynamic.records
    require([r["scene_id"] for r in records] == [1, 2], records)
    require([r["frames"] for r in records] == [40, 8], records)
    require(launches == 6, f"composite_tiles launched {launches} times for 48 frames in 6 chunks")
    again = run_generation(config("dynamic", 2, 2, 4), [env], objs, device=device)
    require(not again.records and rasterize_cuda.composite_tiles.launches == launches,
            "a resumed run rendered again")
    lines = (out / name / "generation_stats.jsonl").read_text().splitlines()
    require(len(lines) == 2, f"{len(lines)} stats records")
    for rec in records:
        require(3 <= rec["n_objects"] <= 6, rec)
        check_bop_tree(out, name, rec["scene_id"], rec["frames"], rec["n_objects"], n_models=len(objs))
        require((out / name / "train" / f"{rec['scene_id']:06d}" / "scene_gt_info.json").exists(),
                "scene_gt_info.json missing")
    report = check_bop_dataset(out, name)
    require(report["ok"], report["errors"])
    for rec, mode in zip(records, ("static", "dynamic")):
        stages = {k: rec[f"t_{k}"] for k in ("physics", "setup", "render", "finalize")}
        shares = {k: round(v / rec["seconds"], 4) for k, v in stages.items()}
        print(f"scene loop {mode} scene {rec['scene_id']}: {rec['frames']} frames, "
              f"{rec['n_objects']} objects, {rec['splats']} splats, {rec['seconds']:.3f} s "
              f"({rec['frames_per_s']:.3f} frames/s with physics, setup and PNG writes); "
              f"seconds {json.dumps({k: round(v, 4) for k, v in stages.items()})} "
              f"shares {json.dumps(shares)} card={card}", flush=True)
    return launches


def scene_variants(device, card: str) -> int:
    """Phase 11: ``generate_scene_variants`` on a 210k-splat template;
    returns the forward kernel's launches."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.parallel import scene_batch
    from pegasus_tpu_torch.parallel.scene_batch import generate_scene_variants
    from pegasus_tpu_torch.physics import rigid_body as rb
    from pegasus_tpu_torch.scene.composition import SceneTemplate
    from pegasus_tpu_torch.testing import make_box_cloud, make_plane_cloud

    rng = np.random.default_rng(7)
    half = (0.06, 0.06, 0.03)
    env = make_plane_cloud(rng, n=150_000, size=2.0, device=device)
    objs = [make_box_cloud(rng, n=10_000, half_extents=half, object_id=i + 1,
                           rgb=((0.2 + 0.1 * i) % 1.0, 0.5, (0.9 - 0.1 * i) % 1.0), device=device)
            for i in range(6)]
    template = SceneTemplate.build(env, objs)
    b = template.num_bodies
    # box bodies: the 8 corners and 6 face centres as collision points,
    # 0.2 kg, a solid box's inertia
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    pts = np.concatenate([signs * half, np.diag(half), -np.diag(half)]).astype(np.float32)
    mass, ext = 0.2, 2 * np.asarray(half)
    inertia = mass / 12.0 * np.array([ext[1]**2 + ext[2]**2, ext[0]**2 + ext[2]**2, ext[0]**2 + ext[1]**2])
    inv_mass = np.array([0.0] + [1.0 / mass] * (b - 1), np.float32)
    inv_inertia = np.zeros((b, 3), np.float32)
    inv_inertia[1:] = 1.0 / inertia
    t = lambda a: torch.tensor(a, device=device)
    params = rb.RigidBodyParams(
        inv_mass=t(inv_mass), inv_inertia=t(inv_inertia),
        points=t(np.tile(pts[None], (b, 1, 1))), point_mask=t(np.ones((b, len(pts)), bool)),
        radius=t(np.full(b, np.linalg.norm(half), np.float32)),
        friction=t(np.full(b, 0.5, np.float32)), restitution=t(np.zeros(b, np.float32)),
        body_mask=t(np.ones(b, bool)), half_extents=t(np.tile(np.asarray(half, np.float32), (b, 1))),
    )
    cam = bench_cameras(device)["orbit"]
    k = b

    def run(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_scene_variants(template, params, cam, SCENE_VARIANTS, n_steps=VARIANT_STEPS,
                                      seed=seed, max_objects=k, device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(0)  # captures the V-wide step
    chunk = scene_batch.VARIANT_CHUNK
    rasterize_cuda.composite_tiles.launches = bin_splats.host_reads = 0
    res, seconds = run(1)
    launches = rasterize_cuda.composite_tiles.launches
    chunks = -(-SCENE_VARIANTS // chunk)
    require(launches == bin_splats.host_reads == chunks,
            f"{launches} launches, {bin_splats.host_reads} host reads for {SCENE_VARIANTS} variants "
            f"in {chunks} chunks of {chunk}")
    # the same drops at VARIANT_CHUNK 1 and then 8 again, in turns: bitwise equal, variants/s each
    rates = {chunk: [SCENE_VARIANTS / seconds]}
    try:
        for c in (1, 1, chunk):
            scene_batch.VARIANT_CHUNK = c
            other, wall = run(1)
            rates.setdefault(c, []).append(SCENE_VARIANTS / wall)
            unequal = [name for name, x, y in zip(res._fields, res, other) if not torch.equal(x, y)]
            require(not unequal, f"VARIANT_CHUNK {c} against {chunk}: {unequal} differ")
            del other
    finally:
        scene_batch.VARIANT_CHUNK = chunk
    require(res.rgb.shape == (SCENE_VARIANTS, HEIGHT, WIDTH, 3)
            and res.seg_weights.shape == (SCENE_VARIANTS, HEIGHT, WIDTH, k), res.rgb.shape)
    require(all(bool(torch.isfinite(x).all()) for x in res), "non-finite variant output")
    require(float((res.rgb[0] - res.rgb[1]).abs().max()) > 0.01, "two variants rendered alike")
    require(float(res.seg_weights[..., 1:].sum(dim=(1, 2, 3)).min()) > 0, "a variant shows no object")
    # the rest gates on the whole recorded drop of the same seed
    gen = torch.Generator().manual_seed(1)
    from pegasus_tpu_torch.parallel.scene_batch import variant_start_states

    states = variant_start_states(SCENE_VARIANTS, b, generator=gen, device=device)
    traj, final = rb.simulate_batch(params, states, n_steps=VARIANT_STEPS, device=device)
    require(torch.equal(final.pos, res.final_pos) and torch.equal(final.rot, res.final_rot),
            "generate_scene_variants' rest poses are not the seed's drop")
    low, speed, share = rest_gates("scene variants", traj.pos, traj.rot, traj.linvel, states.pos,
                                   states.rot, (params.inv_mass > 0) & params.body_mask,
                                   rest_share=VARIANT_REST_SHARE)
    print(f"generate_scene_variants: V = {SCENE_VARIANTS}, {VARIANT_STEPS} steps, {WIDTH}x{HEIGHT}, "
          f"{template.cloud.num_splats} splats, K = {k}: {seconds:.3f} s ({SCENE_VARIANTS / seconds:.3f} "
          f"variants/s), {launches} forward-kernel launches ({launches / SCENE_VARIANTS:.4f} and "
          f"{chunks / SCENE_VARIANTS:.4f} host reads per variant); variants/s by VARIANT_CHUNK in turns "
          f"{chunk}, 1, 1, {chunk} (drop included, outputs bitwise equal): "
          f"{json.dumps({c: [round(r, 3) for r in v] for c, v in rates.items()})}; lowest z {low:.4f}, last |linvel| "
          f"{speed:.4f}, {share:.4f} of {SCENE_VARIANTS * (b - 1)} objects at rest card={card}", flush=True)
    rb.clear_step_programs()
    return launches


def compact_readback_case(data: Path, out: Path, device, card: str) -> int:
    """The static replayed scene of phase 5 twice, without and with
    ``compact_readback`` (the default frame_chunk, 8: 5 chunks): every PNG
    and JSON byte-identical; prints the bytes moved per frame both ways and
    frames/s.  Returns the forward kernel's launches (one per chunk)."""
    from pegasus_tpu_torch.ops import rasterize_cuda

    rasterize_cuda.composite_tiles.launches = 0
    runs = {}
    for name, compact in (("readback_packed", False), ("readback_compact", True)):
        peg = scene_pegasus(data, out, name, "static", 10, 4, device, compact_readback=compact)
        t0 = time.perf_counter()
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        runs[name] = (time.perf_counter() - t0, len(peg.viewport_cam_list), peg.last_render_stats)
    launches = rasterize_cuda.composite_tiles.launches
    a, b = out / "readback_packed", out / "readback_compact"
    kinds = (".png", ".json")
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.suffix in kinds)
    require(files and files == sorted(p.relative_to(b) for p in b.rglob("*") if p.suffix in kinds),
            "the two trees differ in files")
    differ = [str(f) for f in files if (a / f).read_bytes() != (b / f).read_bytes()]
    require(not differ, f"compact readback changed {differ[:5]}")
    (s0, n, st0), (s1, _, st1) = runs["readback_packed"], runs["readback_compact"]
    require(launches == 2 * -(-n // 8), f"{launches} launches for 2 x {n} frames in chunks of 8")
    require(st1["readback_bytes"] < st0["readback_bytes"], (st0, st1))
    print(f"compact readback static {n} frames: {len(files)} PNG and JSON files byte-identical; "
          f"bytes/frame packed {st0['readback_bytes'] / n:.0f} compact {st1['readback_bytes'] / n:.0f} "
          f"(fallback frames {st1['rle_fallback_frames']}); frames/s packed {n / s0:.3f} compact "
          f"{n / s1:.3f} (wall, incl. PNG writes) card={card}", flush=True)
    return launches


def sharded_render_phase(device, card: str, max_objects: int) -> int:
    """Phase 12: ``rasterize_splat_sharded`` (backend "cuda") on lanes of the
    card against the unsharded ``rasterize``; returns the forward kernel's
    launches over the sharded renders."""
    import torch

    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.ops.validate import compare_backends, compare_outputs
    from pegasus_tpu_torch.parallel.mesh import make_mesh
    from pegasus_tpu_torch.parallel.sharded_render import (rasterize_splat_sharded,
                                                           rasterize_splat_sharded_batch)

    scenes, cams = bench_scenes(device), bench_cameras(device)
    bg = (0.1, 0.1, 0.1)
    meshes = {n: make_mesh((n,), ("splat",), [device] * n) for n in (1, 2, 4, 8)}
    total = 0

    def wall_ms(fn, reps=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def counted(fn):
        rasterize_cuda.composite_tiles.launches = 0
        out = fn()
        return out, rasterize_cuda.composite_tiles.launches

    scene = scenes["1M"]
    for cname, cam in cams.items():
        with torch.no_grad():
            unsharded = lambda: rasterize(scene, cam, background=bg, max_objects=max_objects)
            ref = unsharded()
            times = {"unsharded": wall_ms(unsharded)}
        for n, mesh in meshes.items():
            render = lambda: rasterize_splat_sharded(scene, cam, mesh, background=bg,
                                                     max_objects=max_objects, backend="cuda")
            out, launches = counted(render)
            total += launches
            require(launches == n, f"{launches} launches for {n} shards")
            require(all(torch.equal(a, b) for a, b in zip(out, render())),
                    f"1M {cname} {n} lanes: two sharded renders differ")
            require(all(bool(torch.isfinite(x).all()) for x in out), "non-finite sharded render")
            report = compare_outputs(ref, out)
            db = {f: round(float(report[f"{f}_psnr_db"]), 2) for f in ref._fields}
            require(report["min_psnr_db"] >= KERNEL_GATE_DB,
                    f"1M {cname} {n} lanes below {KERNEL_GATE_DB} dB: {db}")
            for f in ref._fields:
                limit = FWD_ABS_GATE * max(1.0, float(getattr(ref, f).abs().max()))
                require(report[f"{f}_max_err"] <= limit,
                        f"1M {cname} {n} lanes: {f} max |diff| {report[f'{f}_max_err']} > {limit}")
            times[f"{n} lanes"] = wall_ms(render)
            print(f"sharded render 1M {cname} {n} lanes vs unsharded: dB={json.dumps(db)} "
                  f"max_abs_err={max(report[f'{f}_max_err'] for f in ref._fields):.3e}, "
                  f"bitwise repeatable, {launches} launches", flush=True)
        print(f"sharded render 1M {cname} ms/frame (host clock ending in synchronize: project, sort, "
              f"bin, composite, combine): {json.dumps({k: round(v, 3) for k, v in times.items()})} "
              f"card={card}", flush=True)

    # against the golden compositor at the 210k scene, 4 lanes
    report, launches = counted(lambda: compare_backends(
        scenes["210k"], cams["orbit"], backend="sharded", mesh=meshes[4],
        max_objects=max_objects, background=bg))
    total += launches
    db = {f: round(float(report[f"{f}_psnr_db"]), 2) for f in ref._fields}
    print(f"sharded render 210k orbit 4 lanes vs golden dB={json.dumps(db)}", flush=True)
    require(launches == 4 and report["min_psnr_db"] >= GOLDEN_GATE_DB,
            f"sharded vs golden below {GOLDEN_GATE_DB} dB ({launches} launches): {db}")

    # the hybrid (2, 4) mesh over two scenes against each scene's own sharded render
    hybrid = make_mesh((2, 4), ("scene", "splat"), [device] * 8)
    pair = [(scenes["210k"], cams["orbit"]), (scenes["1M"], cams["grazing"])]
    batch, launches = counted(lambda: rasterize_splat_sharded_batch(
        [s for s, _ in pair], [c for _, c in pair], hybrid, WIDTH, HEIGHT, background=bg,
        max_objects=max_objects, backend="cuda"))
    total += launches
    require(launches == 8, f"{launches} launches on the (2, 4) mesh")
    require(batch.rgb.shape == (2, HEIGHT, WIDTH, 3), batch.rgb.shape)
    for i, (s, c) in enumerate(pair):
        own = rasterize_splat_sharded(s, c, meshes[4], background=bg, max_objects=max_objects,
                                      backend="cuda")
        require(all(torch.equal(getattr(batch, f)[i], getattr(own, f)) for f in own._fields),
                f"hybrid mesh scene {i} differs from its own sharded render")
    print("sharded render (2, 4) mesh over two scenes: each equals its own 4-lane render bitwise, "
          f"{launches} launches", flush=True)
    return total


def batch_stage_seconds(stats) -> list:
    """The setup / physics / render seconds of each batch of a sharded run."""
    return [{k: round(b[f"t_{k}"], 4) for k in ("setup", "physics", "render")} for b in stats.batches]


def sharded_generation_phase(data: Path, out: Path, device, card: str) -> int:
    """Phase 13: ``run_generation(mesh=)`` over the smoke dataset on a
    4-lane mesh; returns the forward kernel's launches of the gated runs."""
    from pegasus_tpu_torch.config import GenerationConfig
    from pegasus_tpu_torch.eval import check_bop_dataset
    from pegasus_tpu_torch.generate import finalize_dataset, run_generation
    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.parallel import mesh as pmesh
    from pegasus_tpu_torch.physics import rigid_body as rb

    env, objs = smoke_assets(data)

    def config(name, mode, num_scenes, num_cameras, seed, frame_chunk=8, base=out):
        return GenerationConfig(
            dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
            dataset_base_path=str(base), dataset_name=name, num_scenes=num_scenes,
            min_num_objects=3, max_num_objects=6, mode=mode, render_width=WIDTH,
            render_height=HEIGHT, num_cameras=num_cameras, num_camera_interpolation_steps=4,
            camera_trajectory_mode="random", render_data_points=list(MODALITIES),
            simulation_steps=SIM_STEPS, save_video=False, seed=seed, frame_chunk=frame_chunk,
        )

    drops = []  # scenes of each simulate_batch call
    simulate_batch = rb.simulate_batch

    def counted(params, state0, *args, **kwargs):
        drops.append(int(state0.pos.shape[0]))
        return simulate_batch(params, state0, *args, **kwargs)

    rb.simulate_batch = counted
    try:
        name = "smoke_sharded"
        lanes4 = pmesh.make_mesh(devices=[device] * 4)
        rasterize_cuda.composite_tiles.launches = 0
        t0 = time.perf_counter()
        static = run_generation(config(name, "static", 8, 10, 5), [env], objs, mesh=lanes4)
        t_static = time.perf_counter() - t0
        t0 = time.perf_counter()
        # scenes 1-8 are done: the second call resumes past them and adds 9-12, dynamic
        dynamic = run_generation(config(name, "dynamic", 12, 2, 6), [env], objs, mesh=lanes4)
        t_dynamic = time.perf_counter() - t0
        launches = rasterize_cuda.composite_tiles.launches
        records = static.records + dynamic.records
        require([r["scene_id"] for r in records] == list(range(1, 13)), records)
        require(drops == [4, 4, 4], f"simulate_batch calls (scenes each): {drops}, want one per batch")
        # one launch per chunk of 8: 8 static scenes of 40 frames, 4 dynamic of 8
        require(launches == 8 * 5 + 4 * 1, f"{launches} launches for {8 * 40 + 4 * 8} frames written "
                f"in {8 * 5 + 4 * 1} chunks of 8")
        again = run_generation(config(name, "dynamic", 12, 2, 6), [env], objs, mesh=lanes4)
        require(not again.records and rasterize_cuda.composite_tiles.launches == launches
                and len(drops) == 3, "a resumed sharded run rendered or dropped again")
        lines = (out / name / "generation_stats.jsonl").read_text().splitlines()
        require(len(lines) == 12, f"{len(lines)} stats records")
        finalize_dataset(config(name, "dynamic", 12, 2, 6))
        for rec in records:
            require(3 <= rec["n_objects"] <= 6 and rec["binning_overflow_frames"] == 0, rec)
            check_bop_tree(out, name, rec["scene_id"], rec["frames"], rec["n_objects"], n_models=len(objs))
        report = check_bop_dataset(out, name)
        require(report["ok"], report["errors"])
        for rec in dynamic.records:  # the poses move between frames
            gt = json.loads((out / name / "train" / f"{rec['scene_id']:06d}" / "scene_gt.json").read_text())
            moved = max(math.dist(a["T_m2w"][3:12:4], b["T_m2w"][3:12:4])
                        for a, b in zip(gt["0"], gt["7"]))
            require(moved > 1e-4, f"dynamic scene {rec['scene_id']}: no pose moved between frames")
        for label, stats, wall in (("static", static, t_static), ("dynamic", dynamic, t_dynamic)):
            n = len(stats.records)
            print(f"sharded generation {label}: {n} scenes of {stats.records[0]['frames']} frames on 4 "
                  f"lanes in {wall:.3f} s ({wall / n:.3f} s per scene, {n / wall:.3f} scenes/s, writer "
                  f"pool drained); seconds per batch of 4 scenes "
                  f"{json.dumps(batch_stage_seconds(stats))} (physics: one simulate_batch of "
                  f"{SIM_STEPS} steps over the batch) card={card}", flush=True)

        # scenes/s at 1, 2 and 4 lanes (4 static scenes of 40 frames each)
        rates = {}
        for n_lanes in (1, 2, 4):
            mesh = pmesh.make_mesh(devices=[device] * n_lanes)
            t0 = time.perf_counter()
            stats = run_generation(config(f"lanes_{n_lanes}", "static", 4, 10, 7), [env], objs, mesh=mesh)
            wall = time.perf_counter() - t0
            require(len(stats.records) == 4, stats.records)
            stages = batch_stage_seconds(stats)
            rates[f"{n_lanes} lanes"] = {"scenes_per_s": round(4 / wall, 4), "wall_s": round(wall, 3),
                            **{f"{k}_s": round(sum(b[k] for b in stages), 3)
                               for k in ("setup", "physics", "render")}}
        print(f"sharded generation lanes (4 static scenes of 40 frames, {SIM_STEPS} steps, PNG writes "
              f"included): {json.dumps(rates)} card={card}", flush=True)
        sharded_chunk_identity(config, env, objs, pmesh.make_mesh(devices=[device] * 4), out, card)
    finally:
        rb.simulate_batch = simulate_batch
    rb.clear_step_programs()
    return launches


def sharded_chunk_identity(config, env, objs, mesh, out: Path, card: str) -> None:
    """Phase 13's chunk gate: 2 static scenes of 10 x 4 frames, then
    (resuming) 2 dynamic scenes of 2 x 4, on ``mesh`` at ``frame_chunk`` 1,
    8, 8, 1 in turns.  Every turn writes the tree of the first (all files
    but the stats and the config), launches the forward kernel and reads
    the host once per chunk; prints per turn launches and host reads per
    frame and scenes/s."""
    from pegasus_tpu_torch.generate import run_generation
    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.ops.binning import bin_splats

    frames = 2 * 40 + 2 * 8
    turns = []
    for turn, c in enumerate(MAIN_PATH_CHUNKS):
        base = out / f"chunk_turn{turn}"
        rasterize_cuda.composite_tiles.launches = bin_splats.host_reads = 0
        t0 = time.perf_counter()
        static = run_generation(config("chunked", "static", 2, 10, 21, c, base), [env], objs, mesh=mesh)
        dynamic = run_generation(config("chunked", "dynamic", 4, 2, 22, c, base), [env], objs, mesh=mesh)
        wall = time.perf_counter() - t0
        launches, reads = rasterize_cuda.composite_tiles.launches, bin_splats.host_reads
        chunks = 2 * -(-40 // c) + 2 * -(-8 // c)
        require(len(static.records) == len(dynamic.records) == 2, "the chunk runs wrote other scenes")
        require(launches == reads == chunks,
                f"frame_chunk {c}: {launches} launches, {reads} host reads for {chunks} chunks")
        differ = same_trees(out / "chunk_turn0", base,
                            skip=("generation_stats.jsonl", "generation_config.json"))
        require(not differ, f"frame_chunk {c} against {MAIN_PATH_CHUNKS[0]}: {len(differ)} files "
                            f"differ, {differ[:5]}")
        turns.append({"frame_chunk": c, "scenes_per_s": round(4 / wall, 4), "wall_s": round(wall, 3),
                      "launches_per_frame": round(launches / frames, 4),
                      "host_reads_per_frame": round(reads / frames, 4), "files_differing": len(differ)})
    print(f"sharded generation chunk turns (2 static scenes of 40 frames, 2 dynamic of 8, 4 lanes, "
          f"{SIM_STEPS} steps, PNG writes included; trees against the first turn): "
          f"{json.dumps(turns)} card={card}", flush=True)


def dp_step_phase(device, card: str) -> dict:
    """Phase 14: the data-parallel train step at the training shape, four
    cameras on a 4-lane mesh; returns both kernels' launches."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.camera import Camera
    from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.parallel.mesh import make_mesh
    from pegasus_tpu_torch.training.trainer import (GROUPS, GSTrainer, TrainConfig,
                                                    init_from_points)
    from pegasus_tpu_torch.utils import sh as shlib

    gt = train_box_cloud(device)
    cams, gts = [], []
    with torch.no_grad():
        for az in (0.4, 2.0, 3.6, 5.2):
            cam = Camera.look_at(eye=(0.75 * math.cos(az), 0.75 * math.sin(az), 0.5), target=(0, 0, 0),
                                 up=(0, 0, 1), fovx=math.radians(55), fovy=math.radians(55),
                                 width=TRAIN_SIZE, height=TRAIN_SIZE, device=device)
            cams.append(cam)
            gts.append(torch.clamp(rasterize(gt, cam, max_objects=1).rgb, 0, 1))
    rng = np.random.default_rng(3)
    idx = rng.choice(gt.num_splats, SEED_POINTS, replace=False)
    xyz = gt.xyz[idx].cpu().numpy() + rng.normal(size=(SEED_POINTS, 3)) * 0.005
    rgb = np.clip(shlib.sh2rgb(gt.f_dc[idx, 0].cpu().numpy()), 0, 1).astype(np.float32)
    config = TrainConfig(capacity=TRAIN_CAPACITY)
    trainer = GSTrainer(config, width=TRAIN_SIZE, height=TRAIN_SIZE, device=device)
    state = trainer.init_state(init_from_points(xyz.astype(np.float32), rgb, config, device=device))
    mesh = make_mesh((4,), ("batch",), [device] * 4)
    dp_step = trainer.make_dp_train_step(mesh)

    def counts():
        return {"forward": rasterize_cuda.composite_tiles.launches,
                "backward": composite_vjp.composite_tiles_backward.launches}

    rasterize_cuda.composite_tiles.launches = 0
    composite_vjp.composite_tiles_backward.launches = 0
    new, metrics = dp_step(state, cams, gts)
    torch.cuda.synchronize()
    first_step = counts()
    require(first_step == {"forward": 4, "backward": 4}, f"DP step launches {first_step} for 4 cameras")
    require((new.step, new.count) == (state.step + 1, state.count + 1), (new.step, new.count))

    # one _apply_grads of the mean of four single-view gradients
    grads, losses, g2d, denom = [], [], 0.0, 0.0
    for cam, img in zip(cams, gts):
        loss, _, pg, og = trainer._loss_and_grads(state, cam, img)
        a, b = trainer._densify_stats(og)
        grads.append(pg)
        losses.append(float(loss))
        g2d, denom = g2d + a, denom + b
    mean_grad = {g: sum(pg[g] for pg in grads) / 4.0 for g in GROUPS}
    want = trainer._apply_grads(state, mean_grad, g2d, denom)
    # One train step's tolerances (tests/test_torch_training.py): parameters
    # and Adam's first moment rtol 1e-3 / atol 2e-5, the densify statistic
    # rtol 5e-2 / atol 1e-7.  Adam's first update is lr x sign(g), and the
    # scatter of K3's rows to splats sums with atomics: a gradient that
    # cancels to rounding may flip its sign between two runs.  So the moment
    # is held everywhere, and the parameter wherever |g| is above rounding
    # (1e-5 of the group's largest |g|); what lies below is counted.
    close = lambda a, b: torch.isclose(a, b, rtol=1e-3, atol=2e-5)
    rounding, missed = {}, {}
    for g in GROUPS:
        require(bool(close(new.mu[g], want.mu[g]).all()), f"DP step: Adam's moment of {g} differs")
        miss = ~close(getattr(new.cloud, g), getattr(want.cloud, g))
        small = mean_grad[g].abs() <= 1e-5 * mean_grad[g].abs().max()
        require(not bool((miss & ~small).any()),
                f"DP step: {int((miss & ~small).sum())} values of {g} outside rtol 1e-3 / atol 2e-5")
        live = mean_grad[g] != 0
        rounding[g] = float((small & live).sum() / live.sum().clamp(min=1))
        missed[g] = int(miss.sum())
    require(bool(torch.isclose(new.xyz_grad_accum, want.xyz_grad_accum, rtol=5e-2, atol=1e-7).all()),
            "DP step: the densify statistic is not the sum over the views")
    require(torch.equal(new.denom, want.denom), "DP step: denom is not the sum over the views")
    mean_loss = sum(losses) / 4
    require(abs(float(metrics["loss"]) - mean_loss) <= 1e-4 * mean_loss, (float(metrics["loss"]), losses))

    def timed(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    holder = {"dp": new, "single": new}

    def one_dp(_):
        holder["dp"], holder["metrics"] = dp_step(holder["dp"], cams, gts)

    def one_single(i):
        holder["single"], _ = trainer.train_step(holder["single"], cams[i % 4], gts[i % 4])

    # the comparison above launched both kernels too: count the timed steps from 0
    rasterize_cuda.composite_tiles.launches = 0
    composite_vjp.composite_tiles_backward.launches = 0
    dp_ms = timed(one_dp, 19)  # 20 DP steps with the gated one
    require(counts() == {"forward": 76, "backward": 76}, f"DP launches over 19 steps: {counts()}")
    launches = {k: first_step[k] + v for k, v in counts().items()}
    last = float(holder["metrics"]["loss"])
    require(last < float(metrics["loss"]),
            f"20 DP steps did not lower the loss: {float(metrics['loss'])} -> {last}")
    single_ms = timed(one_single, 20)
    print(f"DP step (4 cameras on 4 lanes, {TRAIN_SIZE}x{TRAIN_SIZE}, {SEED_POINTS} alive of "
          f"{TRAIN_CAPACITY}): {dp_ms:.3f} ms/step beside 4 x {single_ms:.3f} = {4 * single_ms:.3f} ms "
          f"for four single steps (host clock ending in synchronize); loss {float(metrics['loss']):.5f} "
          f"-> {last:.5f} over 20 steps; parameter values outside the one-step tolerance "
          f"{json.dumps(missed)}, all of them among the share of nonzero gradients within rounding "
          f"{json.dumps({g: round(v, 6) for g, v in rounding.items()})}; launches {json.dumps(launches)} card={card}", flush=True)
    return launches


def dress_rehearsal_phase(tmp: Path, device, card: str) -> int:
    """Phase 15: the full-roster dress rehearsal through
    ``run_generation(mesh=)``; returns the forward kernel's launches."""
    from pegasus_tpu_torch.assets.rosters import CUP_NOODLE_CLASSES, ENV_CLASSES, YCB_CLASSES
    from pegasus_tpu_torch.config import GenerationConfig
    from pegasus_tpu_torch.eval import check_bop_dataset, score_bop19
    from pegasus_tpu_torch.generate import finalize_dataset, run_generation, write_targets_bop19
    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.parallel.mesh import make_mesh
    from pegasus_tpu_torch.physics import rigid_body as rb
    from pegasus_tpu_torch.testing import build_roster_dataset, gt_as_estimates_csv

    data, out, name = tmp / "roster_data", tmp / "roster_out", "rehearsal"
    t0 = time.perf_counter()
    # the nine environments the reference's main program wires, and all 51 objects
    envs, objs = build_roster_dataset(
        data, list(ENV_CLASSES.values())[:9],
        list(YCB_CLASSES.values()) + list(CUP_NOODLE_CLASSES.values()),
        env_splats=40_000, obj_splats=4_000,
    )
    t_assets = time.perf_counter() - t0
    require(len(envs) == 9 and len(objs) == 51, (len(envs), len(objs)))

    def config(mode, cam_mode, num_scenes, seed):
        return GenerationConfig(
            dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
            dataset_base_path=str(out), dataset_name=name, num_scenes=num_scenes,
            min_num_objects=3, max_num_objects=6, mode=mode, render_width=WIDTH,
            render_height=HEIGHT, num_cameras=2, num_camera_interpolation_steps=3,
            camera_trajectory_mode=cam_mode, render_data_points=list(MODALITIES),
            simulation_steps=SIM_STEPS, save_video=False, seed=seed, resume=True,
        )

    mesh = make_mesh(devices=[device] * 4)
    rasterize_cuda.composite_tiles.launches = 0
    t0 = time.perf_counter()
    # resume carries the dataset from run to run: scenes 1-8, 9-16, then 17-20 dynamic
    runs = [("static", "sequence", 8, 17), ("static", "random", 16, 18),
            ("dynamic", "random+zoom", 20, 19)]
    records = []
    for mode, cam_mode, upto, seed in runs:
        stats = run_generation(config(mode, cam_mode, upto, seed), envs, objs, mesh=mesh)
        records += [dict(rec, mode=mode, camera_mode=cam_mode) for rec in stats.records]
    finalize_dataset(config(*runs[-1]))
    write_targets_bop19(out, name)
    t_generate = time.perf_counter() - t0
    launches = rasterize_cuda.composite_tiles.launches
    require([r["scene_id"] for r in records] == list(range(1, 21)), [r["scene_id"] for r in records])
    # each scene's 6 frames are one chunk at the default frame_chunk of 8
    require(launches == 20, f"{launches} launches for 20 scenes of 6 frames, one chunk each")
    require({r["mode"] for r in records} == {"static", "dynamic"}
            and {r["camera_mode"] for r in records} == {"sequence", "random", "random+zoom"},
            "a scene mode or a camera mode was not used")
    require(all(3 <= r["n_objects"] <= 6 for r in records), [r["n_objects"] for r in records])

    ds = out / name
    minfo = json.loads((ds / "models" / "models_info.json").read_text())
    require(len(minfo) == 51, f"{len(minfo)} models_info entries")
    targets = json.loads((ds / "test_targets_bop19.json").read_text())
    require(len(targets) == sum(6 * r["n_objects"] for r in records), len(targets))
    require(any((ds / "train_ndds").glob("*.json")) and any((ds / "test_ndds").glob("*.json")),
            "the NDDS folders are empty")
    require(all((ds / "train" / f"{sid:06d}" / "scene_gt_info.json").exists() for sid in range(1, 21)),
            "scene_gt_info.json missing")
    check = check_bop_dataset(out, name)
    require(check["ok"] and not check["errors"], check["errors"])
    csv = tmp / "gt_estimates.csv"
    n_est = gt_as_estimates_csv(ds, csv)
    t0 = time.perf_counter()
    scores = score_bop19(csv, out, name)
    t_score = time.perf_counter() - t0
    keep = {k: v for k, v in scores.items() if isinstance(v, (int, float))}
    require(scores["AR"] >= 0.99 and scores["AR_mssd"] == 1.0 and scores["AR_mspd"] == 1.0,
            f"GT poses as estimates score {keep}")
    envs_used = sorted({r["env"] for r in records})
    ids_used = sorted({i for r in records for i in r["object_ids"]})
    print(f"dress rehearsal: 20 scenes (16 static, 4 dynamic) of 6 frames at {WIDTH}x{HEIGHT} on 4 lanes, "
          f"a pool of 9 environments of 40000 splats and 51 objects of 4000; the draws used "
          f"{len(envs_used)} environments and {len(ids_used)} objects; {len(minfo)} models_info entries, "
          f"{len(targets)} targets, check clean, {n_est} GT poses as estimates score {json.dumps(keep)}; "
          f"seconds: assets {t_assets:.2f}, generation {t_generate:.2f} ({20 / t_generate:.3f} scenes/s "
          f"with gt-info, NDDS and targets), scoring {t_score:.2f} card={card}", flush=True)
    rb.clear_step_programs()
    return launches


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _connect(port: int, deadline_s: float = 120.0):
    """A client socket to a server on localhost, retried until it listens."""
    import socket

    end = time.perf_counter() + deadline_s
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=120)
        except OSError:
            require(time.perf_counter() < end, f"no server on port {port}")
            time.sleep(0.02)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        require(chunk, "the GUI server closed the connection mid-message")
        buf += chunk
    return buf


def _read_reply(sock, nbytes: int):
    """(image bytes, verify string) of one reply of the SIBR wire protocol."""
    img = _recv_exact(sock, nbytes)
    n = int.from_bytes(_recv_exact(sock, 4), "little")
    return img, _recv_exact(sock, n).decode("ascii")


def _launches():
    from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda

    return (rasterize_cuda.composite_tiles.launches,
            composite_vjp.composite_tiles_backward.launches)


def _zero_launches():
    from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda

    rasterize_cuda.composite_tiles.launches = 0
    composite_vjp.composite_tiles_backward.launches = 0


def recipe_on_card(tmp: Path, device, card: str):
    """Phase 16 (a): ``hemispherical_object_reconstruction`` on the card
    over a synthetic scan of the training box; returns (asset, scan
    directory, launches {forward, backward})."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.assets.registry import Asset
    from pegasus_tpu_torch.gs.ply import load_gs_ply, read_ply_vertex_data
    from pegasus_tpu_torch.io.mesh import load_mesh
    from pegasus_tpu_torch.reconstruction import recipes
    from pegasus_tpu_torch.scene.dataset import load_colmap_scene
    from pegasus_tpu_torch.testing import install_colmap_stub
    from pegasus_tpu_torch.training.trainer import TrainConfig, init_from_points

    scan, data = tmp / "scan16", tmp / "assets16"
    t0 = time.perf_counter()
    training_scene(scan, device)  # 28 views of the 150k box, 40,000 seed points
    up = data / "object" / "scanned_box" / "up"
    up.mkdir(parents=True)
    (scan / "images").rename(up / "images")
    install_colmap_stub(tmp / "bin16")
    print(f"recipe scan written in {time.perf_counter() - t0:.2f} s; the SfM stage is stubbed "
          f"(no COLMAP on this machine: the stub installs the scan's sparse model)", flush=True)

    seconds = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            if name == "cleaning":
                seconds["translation"] = np.asarray(kwargs["t"], np.float64)
            return out
        return run

    asset = Asset(OBJECT_NAME="scanned_box", ID=901, dataset_path=str(data), SCALE=False, ALPHA=0.05)
    patched = [(recipes.COLMAPReconstruction, "run", "sfm_stub"), (recipes, "_train_gs", "training"),
               (recipes.URDFGenerator, "generate", "urdf"), (recipes, "gs_cleaning", "cleaning")]
    saved_env = {k: os.environ.get(k) for k in ("PATH", "COLMAP_STUB_MODEL")}
    originals = [getattr(obj, attr) for obj, attr, _ in patched]
    os.environ["PATH"] = f"{tmp / 'bin16'}{os.pathsep}{os.environ['PATH']}"
    os.environ["COLMAP_STUB_MODEL"] = str(scan / "sparse" / "0")
    _zero_launches()
    t0 = time.perf_counter()
    try:
        for (obj, attr, name), fn in zip(patched, originals):
            setattr(obj, attr, timed(name, fn))
        recipes.hemispherical_object_reconstruction(asset, train_iterations=TRAIN_ITERATIONS,
                                                    device=device)
    finally:
        for (obj, attr, _), fn in zip(patched, originals):
            setattr(obj, attr, fn)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    fwd_train, bwd = _launches()
    require(bwd == TRAIN_ITERATIONS and fwd_train == TRAIN_ITERATIONS,
            f"recipe training launches forward {fwd_train} backward {bwd} for {TRAIN_ITERATIONS}")

    stages = json.loads((up / "stages.json").read_text())
    require(stages == {"feature_extractor": True, "matcher": True, "mapper": True}, stages)
    cleaned = load_gs_ply(asset.gaussian_point_cloud_path(TRAIN_ITERATIONS), device=device)
    o3d = read_ply_vertex_data(asset.gs_o3d_point_cloud_path(TRAIN_ITERATIONS))
    require(cleaned.num_splats == len(o3d["x"]) > 0,
            f"trained splats {cleaned.num_splats} / o3d {len(o3d['x'])}")
    mesh = load_mesh(asset.urdf_obj_path)
    urdf = Path(asset.urdf_file_path).read_text()
    require(len(mesh.faces) > 100 and "scanned_box.obj" in urdf, (len(mesh.faces), urdf[:200]))
    t = seconds.pop("translation")
    moved = cleaned.xyz.double().mean(0).cpu().numpy() - np.stack([o3d[k] for k in "xyz"], 1).mean(0)
    require(np.abs(moved - t).max() <= 1e-5, f"cleaning moved the centroid by {moved}, not {t}")

    # the trained cloud (the cleaned one moved back) against the seed cloud
    scene = load_colmap_scene(str(up), device=device)
    views = [0, 7, 14, 21]
    cams = [scene["cameras"][i] for i in views]
    gts = [torch.tensor(scene["images"][i], device=device) for i in views]
    seed = init_from_points(scene["points"], scene["colors"], TrainConfig(capacity=TRAIN_CAPACITY),
                            device=device)
    loss0, db0 = eval_views(seed, cams, gts)
    loss1, db1 = eval_views(cleaned.translated(-t), cams, gts)
    require(loss1 < loss0 and db1 > db0, f"recipe: loss {loss0} -> {loss1}, PSNR {db0} -> {db1}")
    fwd, _ = _launches()
    require(fwd == TRAIN_ITERATIONS + 2 * len(views), f"recipe forward launches {fwd}")
    print(f"phase 16a hemispherical recipe: {TRAIN_ITERATIONS} iterations, {wall:.3f} s in all; stage s "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})} (sfm_stub: the stubbed COLMAP; "
          f"urdf: scipy Delaunay alpha shape on the host); stages {sorted(stages)}; splats "
          f"{SEED_POINTS} -> {cleaned.num_splats}; mesh {len(mesh.vertices)} vertices "
          f"{len(mesh.faces)} faces; loss {loss0:.5f} -> {loss1:.5f}, PSNR over 4 training views "
          f"{db0:.3f} -> {db1:.3f} dB; centroid moved by {np.round(moved, 6).tolist()}; launches "
          f"forward {fwd} backward {bwd} card={card}", flush=True)
    return asset, up, {"forward": fwd, "backward": bwd}


def wire_viewer_on_card(ply: str, device, card: str) -> int:
    """Phase 16 (b): ``network_gui.gaussian_splatting_viewer`` in a thread
    serving 20 orbit views at 640x480 to a client socket: each frame equals
    the uint8 of ``rasterize`` of the same camera bitwise, the verify string
    is the ply path, 20 forward launches; then the viewer module's own
    per-view render of the same views.  Returns the forward launches."""
    import threading

    import torch

    from pegasus_tpu_torch import network_gui as ng
    from pegasus_tpu_torch.gs.ply import load_gs_ply
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.viewer import orbit_cameras, render_rgb_u8

    n = 20
    cams = orbit_cameras(center=(0.0, 0.0, 0.0), radius=0.9, elevation_deg=30.0, n_views=n,
                         width=WIDTH, height=HEIGHT, device=device)
    port = _free_port()
    served = {}
    _zero_launches()
    th = threading.Thread(target=lambda: served.update(n=ng.gaussian_splatting_viewer(
        ply, ip="127.0.0.1", port_=port, max_frames=n, device=device)), daemon=True)
    th.start()
    client = _connect(port)
    replies = []
    try:
        t0 = time.perf_counter()
        for cam in cams:
            client.sendall(ng.request_message(cam))
            replies.append(_read_reply(client, WIDTH * HEIGHT * 3))
        wall = time.perf_counter() - t0
    finally:
        client.close()
        th.join(timeout=120)
    served_launches = _launches()[0]
    require(served.get("n") == n and served_launches == n,
            f"viewer served {served.get('n')} frames with {served_launches} forward launches")
    cloud = load_gs_ply(ply, device=device)
    with torch.no_grad():
        for cam, (img, verify) in zip(cams, replies):
            require(verify == ply, f"verify string {verify!r}")
            require(img == ng.frame_bytes(rasterize(cloud, cam, max_objects=1).rgb),
                    "a served frame differs from rasterize of its camera")
    _zero_launches()
    t0 = time.perf_counter()
    views = [render_rgb_u8(cloud, cam, (0.0, 0.0, 0.0)) for cam in cams]
    view_wall = time.perf_counter() - t0
    view_launches = _launches()[0]
    require(view_launches == n, f"viewer per-view renders launched {view_launches}")
    for cam, (img, _), view in zip(cams, replies, views):
        require(view.tobytes() == img, "viewer.render_rgb_u8 differs from the served frame")
    print(f"phase 16b wire viewer: {n} orbit frames at {WIDTH}x{HEIGHT} served in {wall:.3f} s "
          f"({n / wall:.3f} frames/s, client round trips), each bitwise equal to rasterize; "
          f"viewer.render_rgb_u8 {n / view_wall:.3f} views/s; forward launches {served_launches} + "
          f"{view_launches} card={card}", flush=True)
    return served_launches + view_launches


def publish2gui_on_card(data: Path, out: Path, device, card: str) -> int:
    """Phase 16 (c): the static replayed scene of phase 5 with
    ``publish2gui=True`` and a client asking for 3 frames at 640x480 (the
    GUI is polled once per chunk: 5 polls for 40 frames): 3 answered, the
    BOP tree byte-identical to a run without the GUI, forward launches =
    chunks written + frames served.  Returns the forward launches of the
    GUI run."""
    import filecmp
    import threading

    from pegasus_tpu_torch import network_gui as ng
    from pegasus_tpu_torch.pegasus import PEGASUS

    n_req = 3
    peg_plain, n_frames, _ = run_scene(data, out, "gui_off", "static", 10, 4, device)
    del peg_plain
    old_port = PEGASUS.PORT
    PEGASUS.PORT = 0  # ephemeral
    try:
        peg = scene_pegasus(data, out, "gui_on", "static", 10, 4, device, publish2gui=True)
        client = _connect(ng.listener.getsockname()[1])
        cam = peg.viewport_cam_list[0]
        client.sendall(ng.request_message(cam) * n_req)  # queued before the frame loop
        replies = []
        reader = threading.Thread(target=lambda: replies.extend(
            _read_reply(client, WIDTH * HEIGHT * 3) for _ in range(n_req)), daemon=True)
        reader.start()
        _zero_launches()
        t0 = time.perf_counter()
        peg.generate_dataset(MODALITIES, save_bop=True, save_video=False)
        peg.save2bop()
        wall = time.perf_counter() - t0
        launches = _launches()[0]
        reader.join(timeout=120)
        client.close()
    finally:
        PEGASUS.PORT = old_port
        ng.close()
    require(len(replies) == n_req and all(v == str(data) for _, v in replies),
            f"publish2gui answered {len(replies)} of {n_req}")
    n_chunks = -(-n_frames // 8)
    require(launches == n_chunks + n_req, f"forward launches {launches} for {n_chunks} + {n_req}")
    a, b = (out / name / "train" / "000001" for name in ("gui_off", "gui_on"))
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    require(files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file()),
            "the GUI run wrote other files")
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    require(not mismatch and not errors, f"files differ with the GUI on: {mismatch[:5]} {errors[:5]}")
    print(f"phase 16c publish2gui: {n_req} of {n_req} requests answered during a {n_frames}-frame "
          f"static scene ({n_frames / wall:.3f} frames/s with the GUI, PNG writes included), "
          f"{len(files)} files byte-identical to the run without it, forward launches {launches} "
          f"card={card}", flush=True)
    return launches


def trainer_gui_on_card(scene_dir: Path, tmp: Path, device, card: str):
    """Phase 16 (d): ``train_gaussian_splatting_wrapper(gui=True)`` for 20
    iterations on the recipe's scan with a client asking for 3 frames: 3
    answered, 20 backward and 20 + 3 forward launches, the trained
    parameters bitwise equal to a 20-iteration run without the GUI.
    Returns the GUI run's launches {forward, backward}."""
    import threading

    import torch

    from pegasus_tpu_torch import network_gui as ng
    from pegasus_tpu_torch.camera import Camera
    from pegasus_tpu_torch.training.trainer import GROUPS, train_gaussian_splatting_wrapper

    iters, n_req = 20, 3
    kw = dict(TEST_ITERATION=(iters,), SAVE_ITERATION=(iters,), iterations=iters,
              capacity=TRAIN_CAPACITY, device=device)
    port = _free_port()
    result = {}
    _zero_launches()
    th = threading.Thread(target=lambda: result.update(state=train_gaussian_splatting_wrapper(
        str(scene_dir), str(tmp / "gui_model"), gui=True, ip="127.0.0.1", port=port, **kw)),
        daemon=True)
    th.start()
    client = _connect(port, deadline_s=300)
    cam = Camera.look_at((0.6, 0.45, 0.5), (0, 0, 0), (0, 0, 1), math.radians(55), math.radians(45),
                         WIDTH, HEIGHT, device=device)
    replies = []
    try:
        for i in range(n_req):  # the last request hands the loop back to training
            client.sendall(ng.request_message(cam, train=i == n_req - 1))
            replies.append(_read_reply(client, WIDTH * HEIGHT * 3))
    finally:
        client.close()
        th.join(timeout=600)
    require(not th.is_alive() and "state" in result, "the GUI training run did not finish")
    fwd, bwd = _launches()
    require(len(replies) == n_req and all(v == str(tmp / "gui_model") for _, v in replies),
            f"trainer GUI answered {len(replies)} of {n_req}")
    require(bwd == iters and fwd == iters + n_req, f"GUI training launches forward {fwd} backward {bwd}")
    plain = train_gaussian_splatting_wrapper(str(scene_dir), str(tmp / "plain_model"), **kw)
    gui_state = result["state"]
    same = all(torch.equal(getattr(gui_state.cloud, g), getattr(plain.cloud, g)) for g in GROUPS)
    same = same and all(torch.equal(gui_state.mu[g], plain.mu[g]) for g in GROUPS)
    require(same, "the GUI run's parameters differ from the run without it")
    print(f"phase 16d trainer GUI: {n_req} of {n_req} frames answered during {iters} iterations at "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}, parameters and Adam moments bitwise equal to the run without "
          f"the GUI; launches forward {fwd} backward {bwd} card={card}", flush=True)
    return {"forward": fwd, "backward": bwd}


def render_wrappers_on_card(data: Path, out: Path, device, card: str) -> int:
    """Phase 16 (e): the reference-signature render wrappers over phase 5's
    dataset (the 150k environment and the six 10k objects, posed at the
    static scene's step) at one of its cameras: the three mask wrappers
    equal one ``render_frame`` of ``_compose``'s scene bitwise, and
    ``render_rgb_and_depth`` one ``rasterize`` call.  Returns the forward
    launches of the four wrapper calls."""
    import torch

    from pegasus_tpu_torch.gs.cloud import GaussianCloud
    from pegasus_tpu_torch.ops import render as R
    from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
    from pegasus_tpu_torch.scene.composition import pose_scene

    peg = scene_pegasus(data, out, "wrappers", "static", 10, 4, device)
    posed = pose_scene(peg.template, *peg._body_poses_at(peg._initial_step))
    part = lambda k: GaussianCloud(**{f: getattr(posed, f)[posed.object_id == k]
                                      for f in GaussianCloud.__dataclass_fields__})
    env = part(0)
    objs = {k: part(k) for k in range(1, peg.template.num_bodies)}
    colors, cam = peg._semantic_colors_dev, peg.viewport_cam_list[0]
    scene = R._compose(env, objs)[0]
    _zero_launches()
    with torch.no_grad():
        vis, seg = R.render_visib_mask(cam, env, objs, colors)
        sil = R.render_silhouette_mask(cam, objs, env, color_set=colors)
        sem = R.render_semanticsegmentation_mask(cam, env, objs, colors)
        rgb, depth = R.render_rgb_and_depth(cam, scene)
        launches = _launches()[0]
        frame = R.render_frame(scene, cam, colors)
        plain = rasterize(scene.with_object_id(0), cam, max_objects=1)
    require(launches == 4, f"render wrappers launched {launches} for 4 calls")
    require(torch.equal(vis, frame.mask_visib) and torch.equal(seg, frame.seg_image)
            and torch.equal(sil, frame.mask_amodal)
            and (sem == (frame.seg_image * 255).to(torch.uint8).cpu().numpy()).all(),
            "a mask wrapper differs from render_frame")
    require(torch.equal(rgb, torch.clamp(plain.rgb, 0, 1)) and torch.equal(depth, plain.depth[..., None]),
            "render_rgb_and_depth differs from rasterize")
    require(bool(vis.any()), "no object visible at the wrappers' camera")
    print(f"phase 16e render wrappers: {len(objs)} objects at {WIDTH}x{HEIGHT}, visible, amodal and "
          f"semantic masks bitwise equal to render_frame, rgb and depth to rasterize; "
          f"{int(vis.sum())} visible and {int(sil.sum())} amodal object pixels; forward launches "
          f"{launches} card={card}", flush=True)
    return launches


def asset_and_viewing_phase(tmp: Path, data: Path, out: Path, device, card: str) -> dict:
    """Phase 16: asset building and viewing on the card, (a)-(e).  Returns
    the launches {reconstruction, gui, render_wrappers} of each kernel."""
    t0 = time.perf_counter()
    asset, scan_up, rec = recipe_on_card(tmp, device, card)
    gui_fwd = wire_viewer_on_card(asset.gaussian_point_cloud_path(TRAIN_ITERATIONS), device, card)
    gui_fwd += publish2gui_on_card(data, out, device, card)
    trainer = trainer_gui_on_card(scan_up, tmp, device, card)
    wrappers = render_wrappers_on_card(data, out, device, card)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s card={card}", flush=True)
    return {"forward": {"reconstruction": rec["forward"], "gui": gui_fwd + trainer["forward"],
                        "render_wrappers": wrappers},
            "backward": {"reconstruction": rec["backward"], "gui": trainer["backward"],
                         "render_wrappers": 0}}


TILED_CAP = 1024  # max_per_tile of the reference's tiled renderer and trainer (its default)


def tiled_render_case(device, card: str, k: int) -> dict:
    """Phase 17 (a): the 210k orbit view through ``rasterize_tiled`` at the
    default cap; returns its K1 launches and the numbers for the kernels
    line."""
    import torch

    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.ops.binning import bin_splats, cap_bins
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import (composite_tiles, composite_tiles_torch,
                                                       outputs_from_channels, rasterize)
    from pegasus_tpu_torch.ops.rasterize_tiled import rasterize_tiled

    scene = bench_scenes(device, ("210k",))["210k"]
    cam = bench_cameras(device)["orbit"]
    rasterize_cuda.composite_tiles.launches = 0
    with torch.no_grad():
        out = rasterize_tiled(scene, cam, max_objects=k, max_per_tile=TILED_CAP)
    torch.cuda.synchronize()
    launches = rasterize_cuda.composite_tiles.launches
    require(launches == 1, f"rasterize_tiled launched K1 {launches} times")
    require(all(bool(torch.isfinite(f).all()) for f in out), "non-finite capped render")

    bins = bin_splats(project_gaussians(scene, cam), WIDTH, HEIGHT)
    capped = cap_bins(bins, TILED_CAP)
    longest = int(bins.tile_count.max())
    tiles_capped = int((bins.tile_count > TILED_CAP).sum())
    kept = int(capped.tile_count.sum())
    dropped = bins.entry_splat.numel() - kept
    require(tiles_capped > 0 and dropped > 0, f"the cap does not bind: longest segment {longest}")
    err = forward_vs_plain(f"210k orbit capped at {TILED_CAP}", capped, WIDTH, HEIGHT, k)
    bg = (0.0, 0.0, 0.0)
    direct = outputs_from_channels(composite_tiles(capped, WIDTH, HEIGHT, k), bg, k)
    require(all(torch.equal(a, b) for a, b in zip(out, direct)),
            "rasterize_tiled differs from K1 on cap_bins")
    with torch.no_grad():
        wide = rasterize_tiled(scene, cam, max_objects=k, max_per_tile=longest)
        plain_render = rasterize(scene, cam, max_objects=k)
    require(all(torch.equal(a, b) for a, b in zip(wide, plain_render)),
            f"rasterize_tiled at max_per_tile={longest} differs from rasterize")

    render_ms, rasterize_ms, render_runs = time_pair(
        lambda: rasterize_tiled(scene, cam, max_objects=k, max_per_tile=TILED_CAP),
        lambda: rasterize(scene, cam, max_objects=k), n_kernel=10, n_plain=10)
    ms, full_ms, k1_runs = time_pair(lambda: composite_tiles(capped, WIDTH, HEIGHT, k),
                                     lambda: composite_tiles(bins, WIDTH, HEIGHT, k), n_plain=20)
    plain_ms = min(cuda_ms(lambda: composite_tiles_torch(capped, WIDTH, HEIGHT, k), 1) for _ in range(2))
    cap_ms = cuda_ms(lambda: cap_bins(bins, TILED_CAP), 20)
    bound_ms, bound_by = compositor_bounds(capped, WIDTH, HEIGHT, k)["fwd"]
    print(f"tiled render 210k orbit K={k} max_per_tile={TILED_CAP}: longest segment {longest}, "
          f"{tiles_capped} of {bins.tile_count.numel()} tiles capped, {dropped} of "
          f"{bins.entry_splat.numel()} entries dropped; K1 launches {launches}; bitwise equal to "
          f"rasterize at max_per_tile={longest}; rasterize_tiled {render_runs[1]:.4f}/{render_runs[2]:.4f} "
          f"ms, rasterize {render_runs[0]:.4f}/{render_runs[3]:.4f} ms (project, bin and K1); K1 capped "
          f"{k1_runs[1]:.4f}/{k1_runs[2]:.4f} ms, full {k1_runs[0]:.4f}/{k1_runs[3]:.4f} ms, plain "
          f"capped {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); cap_bins {cap_ms:.4f} ms "
          f"card={card}", flush=True)
    return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "render_ms": render_ms,
            "rasterize_ms": rasterize_ms, "dropped": dropped, "tiles_capped": tiles_capped}


def tiled_training_case(device, card: str) -> dict:
    """Phase 17 (b): ``GSTrainer(..., backend="tiled")`` at the training
    shape; returns its K2′ and K3 launches and ms per step."""
    import torch

    from pegasus_tpu_torch.camera import Camera
    from pegasus_tpu_torch.ops import composite_vjp, rasterize_cuda
    from pegasus_tpu_torch.ops.binning import bin_splats, cap_bins
    from pegasus_tpu_torch.ops.composite_vjp import N_GRAD, entry_grads_to_splats
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import CHUNK_ENTRIES, rasterize
    from pegasus_tpu_torch.training.trainer import GSTrainer, TrainConfig

    box = train_box_cloud(device)
    cams = [train_camera(device)] + [
        Camera.look_at(eye=(0.75 * math.cos(a), 0.75 * math.sin(a), 0.5), target=(0, 0, 0),
                       up=(0, 0, 1), fovx=math.radians(55), fovy=math.radians(55),
                       width=TRAIN_SIZE, height=TRAIN_SIZE, device=device)
        for a in (1.2, 2.8, 4.4)]
    with torch.no_grad():
        gts = [torch.clamp(rasterize(box, cam, max_objects=1).rgb, 0, 1) for cam in cams]
    gen = torch.Generator().manual_seed(17)
    start = box.replace(f_dc=box.f_dc + 0.3 * torch.randn(box.f_dc.shape, generator=gen).to(device),
                        opacity=box.opacity + 0.5 * torch.randn(box.opacity.shape, generator=gen).to(device))
    bins = bin_splats(project_gaussians(start, cams[0]), TRAIN_SIZE, TRAIN_SIZE)
    tiles_capped = int((bins.tile_count > TILED_CAP).sum())
    dropped = bins.entry_splat.numel() - int(cap_bins(bins, TILED_CAP).tile_count.sum())
    require(tiles_capped > 0, f"the cap does not bind at the training shape: {int(bins.tile_count.max())}")
    config = TrainConfig(capacity=TRAIN_CAPACITY)
    tiled = GSTrainer(config, None, TRAIN_SIZE, TRAIN_SIZE, max_per_tile=TILED_CAP, backend="tiled",
                      device=device)
    state = tiled.init_state(start)

    rasterize_cuda.composite_tiles.launches = composite_vjp.composite_tiles_backward.launches = 0
    losses = []
    for i in range(20):
        state, metrics = tiled.train_step(state, cams[i % 4], gts[i % 4])
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    launches = {"forward": rasterize_cuda.composite_tiles.launches,
                "backward": composite_vjp.composite_tiles_backward.launches}
    require(launches == {"forward": 20, "backward": 20}, f"tiled training launches {launches}")
    first, last = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    require(last < first, f"tiled training: loss {first} -> {last}")

    one, _ = tiled.train_step(state, cams[1], gts[1])
    two, _ = tiled.train_step(state, cams[1], gts[1])
    differ = train_state_differences(one, two)
    require(not differ, f"two tiled train_steps from one state differ: {differ}")

    # one step's K3 rows against the plain version on the step's own capped bins
    seen = {}
    real = composite_vjp.composite_tiles_backward

    def spy(bins_, grad, out, partials, width, height, k, *rest):
        seen.update(bins=bins_, grad=grad.clone(), out=out, partials=partials)
        return real(bins_, grad, out, partials, width, height, k, *rest)

    spy.launches = real.launches  # the wrapper counts through the module's name
    composite_vjp.composite_tiles_backward = spy
    try:
        tiled.train_step(state, cams[0], gts[0])
    finally:
        composite_vjp.composite_tiles_backward = real
        real.launches = spy.launches
    step_bins = seen["bins"]
    n_keep = int(step_bins.tile_count.sum())
    require(int(step_bins.tile_count.max()) == TILED_CAP and n_keep < step_bins.entry_splat.numel(),
            "the step's bins are not capped")
    with torch.no_grad():
        rows = backward_rows_vs_plain("tiled step 512x512 K=1", step_bins, seen["grad"], seen["out"],
                                      seen["partials"], TRAIN_SIZE, TRAIN_SIZE, 1, CHUNK_ENTRIES)
    g = torch.randn((N_GRAD, step_bins.entry_splat.numel()),
                    generator=torch.Generator().manual_seed(11)).to(device)
    g[:, n_keep:] = float("nan")  # rows of dropped entries are never read
    sums = [entry_grads_to_splats(step_bins, g) for _ in range(3)]
    ref = torch.zeros(N_GRAD, step_bins.params.shape[1], dtype=torch.float64)
    ref.index_add_(1, step_bins.entry_splat[:n_keep].cpu().long(), g[:, :n_keep].cpu().double())
    diff = float((sums[0][:N_GRAD].cpu().double() - ref).abs().max())
    require(all(torch.equal(sums[0], x) for x in sums[1:]) and diff <= 1e-6 * float(ref.abs().max()),
            f"sum to splats of capped bins: repeatable {[torch.equal(sums[0], x) for x in sums[1:]]}, "
            f"max|diff| {diff}")

    auto = GSTrainer(config, None, TRAIN_SIZE, TRAIN_SIZE, device=device)
    states = {"tiled": state, "auto": auto.init_state(start)}
    trainers = {"tiled": tiled, "auto": auto}

    def timed(name):
        st = states[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            st, _ = trainers[name].train_step(st, cams[i % 4], gts[i % 4])
        torch.cuda.synchronize()
        states[name] = st
        return (time.perf_counter() - t0) * 1e3 / 10

    timed("auto")  # warm-up
    runs = [timed(name) for name in ("auto", "tiled", "tiled", "auto")]
    print(f"tiled training 512x512 max_per_tile={TILED_CAP}: {tiles_capped} tiles capped, {dropped} "
          f"entries dropped at the first view; 20 steps, launches {json.dumps(launches)}, loss "
          f"{first:.5f} -> {last:.5f} (mean of 4 steps); two steps from one state bitwise equal; K3 "
          f"rows vs plain on the step's capped bins min_cosine {min(c for c, _, _ in rows):.8f} "
          f"max_abs_err {max(e for _, e, _ in rows):.3e}; sum to splats bitwise repeatable, max|diff| "
          f"{diff:.3e} against a float64 host sum of the kept entries; train_step ms tiled "
          f"{runs[1]:.3f}/{runs[2]:.3f}, auto {runs[0]:.3f}/{runs[3]:.3f} (host clock over 10 steps "
          f"ending in synchronize) card={card}", flush=True)
    return {**launches, "tiled_ms": min(runs[1:3]), "auto_ms": min(runs[0], runs[3])}


def golden_tree_gates(a_root: Path, b_root: Path) -> dict:
    """A scene tree written with ``rasterize_fn=rasterize_reference``
    (``a_root``) against one written with the kernel: the same files, JSON
    bytes equal, rgb >= GOLDEN_GATE_DB, masks <= 0.5 % of pixels, depth within
    1 mm on >= 99 % of covered pixels.  Returns the worst of each."""
    import numpy as np

    files = sorted(p.relative_to(a_root) for p in a_root.rglob("*") if p.is_file())
    require(files == sorted(p.relative_to(b_root) for p in b_root.rglob("*") if p.is_file()),
            "the golden and kernel trees hold other files")
    worst = {"rgb_db": float("inf"), "mask": 0.0, "depth_1mm": 1.0}
    for rel in files:
        a, b = a_root / rel, b_root / rel
        if rel.suffix != ".png":
            require(a.read_bytes() == b.read_bytes(), f"{rel} differs between renderers")
            continue
        x, y = _read_png(a).astype(np.float64), _read_png(b).astype(np.float64)
        kind = rel.parts[0]
        if kind == "rgb":
            mse = float(((x - y) ** 2).mean()) / 255.0**2
            worst["rgb_db"] = min(worst["rgb_db"], float("inf") if mse == 0 else -10 * math.log10(mse))
        elif kind == "depth":
            covered = (x > 0) | (y > 0)
            if covered.any():
                worst["depth_1mm"] = min(worst["depth_1mm"], float((np.abs(x - y)[covered] <= 1).mean()))
        else:
            differ = (x != y).reshape(x.shape[0], x.shape[1], -1).any(-1).mean()
            worst["mask"] = max(worst["mask"], float(differ))
    require(worst["rgb_db"] >= GOLDEN_GATE_DB and worst["mask"] <= 0.005 and worst["depth_1mm"] >= 0.99,
            f"rasterize_fn=rasterize_reference against None: {worst}")
    return worst


def renderer_choice_case(tmp: Path, data: Path, out: Path, device, card: str) -> int:
    """Phase 17 (c): ``PEGASUS(rasterize_fn=)`` with the tiled renderer on
    phase 5's static scene and with the golden compositor on a small scene
    beside ``rasterize_fn=None``; returns the K1 launches."""
    from pegasus_tpu_torch.eval import check_bop_dataset
    from pegasus_tpu_torch.ops import rasterize_cuda
    from pegasus_tpu_torch.ops.rasterize_ref import rasterize_reference
    from pegasus_tpu_torch.ops.rasterize_tiled import rasterize_tiled
    from pegasus_tpu_torch.testing import SMOKE_OBJECTS, build_synthetic_dataset

    rasterize_cuda.composite_tiles.launches = 0
    _, n, host = run_scene(data, out, "smoke_static_tiled", "static", 10, 4, device, frame_chunk=8,
                           rasterize_fn=rasterize_tiled)
    require(n == 40 and host["launches"] == host["host_reads"] == n,
            f"rasterize_fn=rasterize_tiled: {host['launches']} launches for {n} frames")
    report = check_bop_dataset(out, "smoke_static_tiled")
    require(report["ok"], report["errors"])

    small = tmp / "small_data"
    build_synthetic_dataset(small, object_names=[n_ for n_, _ in SMOKE_OBJECTS],
                            env_splats=20_000, obj_splats=2_000)
    t0 = time.perf_counter()
    _, n_small, golden = run_scene(small, out, "smoke_golden", "static", 2, 4, device, frame_chunk=8,
                                   rasterize_fn=rasterize_reference)
    golden_s = time.perf_counter() - t0
    _, _, kernel = run_scene(small, out, "smoke_golden_none", "static", 2, 4, device, frame_chunk=8)
    launches = rasterize_cuda.composite_tiles.launches
    require(golden["launches"] == 0 and kernel["launches"] == 1, (golden["launches"], kernel["launches"]))

    worst = golden_tree_gates(out / "smoke_golden" / "train" / "000001",
                              out / "smoke_golden_none" / "train" / "000001")
    print(f"renderer choice: PEGASUS(rasterize_fn=rasterize_tiled) {n} frames, {host['launches']} K1 "
          f"launches (one per frame), {n / host['wall_s']:.3f} frames/s with PNG writes, "
          f"check_bop_dataset clean; rasterize_fn=rasterize_reference on {n_small} frames of a "
          f"20k + 6 x 2k splat scene {golden_s:.3f} s (0 K1 launches) against rasterize_fn=None "
          f"(1 launch): JSON bytes equal, worst rgb {worst['rgb_db']:.2f} dB, masks "
          f"{100 * worst['mask']:.4f} % of pixels, depth within 1 mm on "
          f"{100 * worst['depth_1mm']:.4f} % card={card}", flush=True)
    return launches


def renderer_seam_phase(tmp: Path, data: Path, out: Path, device, card: str, k: int) -> dict:
    """Phase 17: a caller's renderer on the existing kernels.  Returns the
    launches of each kernel over the phase's main-path runs (comparisons
    with the plain versions excluded) and the capped-bins numbers."""
    import torch

    t0 = time.perf_counter()
    render = tiled_render_case(device, card, k)
    torch.cuda.empty_cache()
    train = tiled_training_case(device, card)
    torch.cuda.empty_cache()
    generate = renderer_choice_case(tmp, data, out, device, card)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s card={card}", flush=True)
    return {"forward": render["launches"] + train["forward"] + generate,
            "backward": train["backward"], "render": render, "train": train}


CROWD_OBJECTS = 48  # phase 18's objects per scene: K = 49
CROWD_ENV_SPLATS = 150_000
CROWD_OBJ_SPLATS = 4_000  # phase 15's roster objects
# Phase 18's drop volume: 48 objects spawned in a roster environment's own
# region (+-0.15 m, 0.25-0.45 m high) start deep inside each other and the
# contact solver throws them kilometres away (the JAX package's engine does
# the same); over +-0.3 m and 0.3-1.2 m they land in a pile within 310 steps.
CROWD_DROP_REGION = (0.3, 0.3)
CROWD_DROP_HEIGHT = (0.3, 1.2)


def relabel_objects(cloud, k: int):
    """``cloud`` with object ids folded into 1 .. K - 1 (id -> 1 + (id - 1)
    % (K - 1); the environment stays 0): the same splats composited at
    another K."""
    oid = cloud.object_id
    return cloud.replace(object_id=(oid - 1).remainder(k - 1).add(1).where(oid > 0, oid))


def roster_replay(data: Path, out: Path, name: str, envs, objs, physics_file: Path, env_name: str,
                  num_cameras: int, device, rasterize_fn=None):
    """A static PEGASUS over roster assets replaying a recorded drop, set up
    up to ``init_start_position``."""
    from pegasus_tpu_torch.pegasus import PEGASUS

    peg = PEGASUS(
        dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
        gs_env_list=envs, gs_object_list=objs, mode="static", camera_trajectory_mode="random",
        render_height=HEIGHT, render_width=WIDTH, num_cameras=num_cameras, simulation_steps=SIM_STEPS,
        num_camera_interpolation_steps=4, dataset_base_path=str(out), seed=3, QUIET=True,
        device=device, frame_chunk=8, rasterize_fn=rasterize_fn,
    )
    peg.physics_file = str(physics_file)
    peg.selected_env_name = env_name
    peg.init(name, 1)
    peg.init_start_position()
    return peg


def crowded_generation(data: Path, out: Path, envs, objs, device, card: str) -> dict:
    """Phase 18 (a): ``run_generation`` over one static scene (10 x 4
    frames) and one dynamic scene (2 x 4) of 48 objects each, with their
    own drops; the forward kernel's launches counted over the two runs."""
    from pegasus_tpu_torch.config import GenerationConfig
    from pegasus_tpu_torch.eval import check_bop_dataset
    from pegasus_tpu_torch.generate import run_generation
    from pegasus_tpu_torch.ops import rasterize_cuda

    name = "crowded"

    def config(mode, num_scenes, num_cameras, seed):
        return GenerationConfig(
            dataset_path=str(data), env_dataset_path=str(data), urdf_asset_folder=str(data / "urdf"),
            dataset_base_path=str(out), dataset_name=name, num_scenes=num_scenes,
            min_num_objects=CROWD_OBJECTS, max_num_objects=CROWD_OBJECTS, mode=mode,
            render_width=WIDTH, render_height=HEIGHT, num_cameras=num_cameras,
            num_camera_interpolation_steps=4, camera_trajectory_mode="random",
            render_data_points=list(MODALITIES), simulation_steps=SIM_STEPS, save_video=False,
            seed=seed, frame_chunk=8,
        )

    rasterize_cuda.composite_tiles.launches = 0
    t0 = time.perf_counter()
    static = run_generation(config("static", 1, 10, 21), envs, objs, device=device)
    dynamic = run_generation(config("dynamic", 2, 2, 22), envs, objs, device=device)
    wall = time.perf_counter() - t0
    launches = rasterize_cuda.composite_tiles.launches
    records = static.records + dynamic.records
    require([r["scene_id"] for r in records] == [1, 2] and [r["frames"] for r in records] == [40, 8],
            records)
    require(launches == 6, f"composite_tiles launched {launches} times for 48 frames in 6 chunks")
    for rec in records:
        require(rec["n_objects"] == CROWD_OBJECTS, rec)
        # scene_gt holds 48 objects per frame, and each frame 48 mask and 48 mask_visib PNGs
        check_bop_tree(out, name, rec["scene_id"], rec["frames"], CROWD_OBJECTS, n_models=len(objs))
    report = check_bop_dataset(out, name)
    require(report["ok"] and not report["errors"], report["errors"])
    frames = sum(r["frames"] for r in records)
    for rec, mode in zip(records, ("static", "dynamic")):
        stages = {k: round(rec[f"t_{k}"], 4) for k in ("physics", "setup", "render", "finalize")}
        print(f"crowded scene {mode} scene {rec['scene_id']}: {rec['frames']} frames, "
              f"{rec['n_objects']} objects (K = {rec['n_objects'] + 1}), {rec['splats']} splats, "
              f"{rec['seconds']:.3f} s ({rec['frames_per_s']:.3f} frames/s with physics, setup and "
              f"PNG writes; {rec['frames'] / rec['t_render']:.3f} frames/s render + PNG writes); "
              f"seconds {json.dumps(stages)} card={card}", flush=True)
    print(f"crowded generation: {frames} frames, {launches} forward-kernel launches "
          f"({launches / frames:.4f} per frame), {frames / wall:.3f} frames/s over both runs, "
          f"check_bop_dataset clean card={card}", flush=True)
    static_rec = records[0]
    return {"launches": launches, "frames": frames, "wall_s": wall, "records": records,
            "physics_file": out / name / "engine" / f"{static_rec['scene_id']:06d}_simulation_steps.json",
            "env": static_rec["env"]}


def crowded_kernel_checks(scene, cams, cloud_210k, device, card: str) -> dict:
    """Phase 18 (b): K1 and K3 at K = 33 and 49 on a frame of the crowded
    scene against their plain versions (and at K = 7 on the same view,
    ids folded, for the times), each kernel twice bitwise; K1 at K = 64 on
    the 210k bench scene with its box splats relabelled 1 + i % 63; one
    launch over a chunk of 8 frames at K = 49 bitwise equal to the 8
    single-frame launches."""
    import torch

    from pegasus_tpu_torch.camera import CameraBatch
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.composite_vjp import composite_tiles_backward
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import composite_tiles, num_channels

    k_full = CROWD_OBJECTS + 1
    cam = cams[0]
    res = {}
    for k in (7, 33, k_full):
        view = scene if k == k_full else relabel_objects(scene, k)
        bins = bin_splats(project_gaussians(view, cam), WIDTH, HEIGHT)
        require(bins.max_object_id < k and (k != k_full or bins.max_object_id > 32),
                f"K = {k}: largest object id in view {bins.max_object_id}")
        res[k] = backward_vs_plain(f"crowded frame {WIDTH}x{HEIGHT} K={k}", bins, WIDTH, HEIGHT, k, card)
        first, partials = composite_tiles(bins, WIDTH, HEIGHT, k, return_partials=True)
        require(torch.equal(first, composite_tiles(bins, WIDTH, HEIGHT, k)),
                f"K1 at K = {k}: two launches differ")
        g = torch.randn((HEIGHT, WIDTH, num_channels(k)),
                        generator=torch.Generator().manual_seed(k)).to(device)
        grad = composite_tiles_backward(bins, g, first, partials, WIDTH, HEIGHT, k)
        require(torch.equal(grad, composite_tiles_backward(bins, g, first, partials, WIDTH, HEIGHT, k)),
                f"K3 at K = {k}: two launches differ")
        del bins, first, partials, grad
        torch.cuda.empty_cache()

    # K = 64: the 210k bench scene's 60,000 box splats take the ids 1 + i % 63
    oid = cloud_210k.object_id.clone()
    box = torch.nonzero(oid > 0)[:, 0]
    oid[box] = (1 + torch.arange(box.numel(), device=oid.device) % 63).to(oid.dtype)
    bins = bin_splats(project_gaussians(cloud_210k.replace(object_id=oid), bench_cameras(device)["orbit"]),
                      WIDTH, HEIGHT)
    require(bins.max_object_id == 63, bins.max_object_id)
    err_64 = forward_vs_plain(f"210k orbit {WIDTH}x{HEIGHT} K=64 (box splats 1 + i % 63)", bins, WIDTH, HEIGHT, 64)
    require(torch.equal(composite_tiles(bins, WIDTH, HEIGHT, 64), composite_tiles(bins, WIDTH, HEIGHT, 64)),
            "K1 at K = 64: two launches differ")
    del bins
    torch.cuda.empty_cache()

    # one launch over 8 frames at K = 49 against the frames' own launches
    chunk_cams = cams[:8]
    bins = bin_splats(project_gaussians(scene, CameraBatch.stack(chunk_cams)), WIDTH, HEIGHT)
    chunk = composite_tiles(bins, WIDTH, HEIGHT, k_full)
    singles = [bin_splats(project_gaussians(scene, c), WIDTH, HEIGHT) for c in chunk_cams]
    for f, one in enumerate(singles):
        require(torch.equal(chunk[f], composite_tiles(one, WIDTH, HEIGHT, k_full)),
                f"K = {k_full}: frame {f} of the chunk launch differs from its own launch")
    chunk_ms = cuda_ms(lambda: composite_tiles(bins, WIDTH, HEIGHT, k_full), 10)
    frames_ms = cuda_ms(lambda: [composite_tiles(b, WIDTH, HEIGHT, k_full) for b in singles], 10)
    chunk_bound = compositor_bounds(bins, WIDTH, HEIGHT, k_full)["fwd"]
    del bins, chunk, singles
    torch.cuda.empty_cache()
    a, b = res[7], res[k_full]
    print(f"crowded K1/K3 at K = {k_full} against K = 7 on the same view (ids folded): "
          f"K1 {b['fwd_ms']:.4f} ms (bound {b['fwd'][0]:.4f} ms, {b['fwd'][1]}) against "
          f"{a['fwd_ms']:.4f} ms (bound {a['fwd'][0]:.4f} ms); K3 {b['ms']:.4f} ms (bound "
          f"{b['bwd'][0]:.4f} ms, {b['bwd'][1]}) against {a['ms']:.4f} ms (bound {a['bwd'][0]:.4f} ms); "
          f"K = 33: K1 {res[33]['fwd_ms']:.4f} ms, K3 {res[33]['ms']:.4f} ms; "
          f"K1 over 8 frames at K = {k_full}: {chunk_ms:.4f} ms in one launch, {frames_ms:.4f} ms "
          f"in 8 (bound {chunk_bound[0]:.4f} ms, {chunk_bound[1]}), bitwise equal card={card}", flush=True)
    return {"k": res, "fwd_max_abs_err": max(err_64, *(r["fwd_max_abs_err"] for r in res.values())),
            "err_64": err_64, "chunk_ms": chunk_ms, "frames_ms": frames_ms, "chunk_bound": chunk_bound}


def crowded_golden_case(tmp: Path, out: Path, physics_file: Path, env_name: str, device,
                        card: str) -> dict:
    """Phase 18 (c): the static crowded drop replayed over small assets
    (a 20,000-splat environment and 48 objects of 500: the golden costs
    O(pixels x splats)), 4 frames written with ``rasterize_fn=
    rasterize_reference`` and with the kernel (K = 49): the golden gates."""
    from pegasus_tpu_torch.assets.rosters import CUP_NOODLE_CLASSES, ENV_CLASSES, YCB_CLASSES
    from pegasus_tpu_torch.ops.rasterize_ref import rasterize_reference
    from pegasus_tpu_torch.testing import build_roster_dataset

    small = tmp / "crowded_small"
    env_cls = next(c for c in ENV_CLASSES.values() if c(small).object_name == env_name)
    envs, objs = build_roster_dataset(small, [env_cls],
                                      list(YCB_CLASSES.values()) + list(CUP_NOODLE_CLASSES.values()),
                                      env_splats=20_000, obj_splats=500)
    t0 = time.perf_counter()
    golden = roster_replay(small, out, "crowded_golden", envs, objs, physics_file, env_name, 1, device,
                           rasterize_fn=rasterize_reference)
    golden.generate_dataset(MODALITIES, save_bop=True, save_video=False)
    golden.save2bop()
    golden_s = time.perf_counter() - t0
    kernel = roster_replay(small, out, "crowded_kernel", envs, objs, physics_file, env_name, 1, device)
    kernel.generate_dataset(MODALITIES, save_bop=True, save_video=False)
    kernel.save2bop()
    n = len(kernel.viewport_cam_list)
    require(n == 4 and len(kernel.bullet_ids) == CROWD_OBJECTS, (n, len(kernel.bullet_ids)))
    worst = golden_tree_gates(out / "crowded_golden" / "train" / "000001",
                              out / "crowded_kernel" / "train" / "000001")
    print(f"crowded golden: {n} frames of a 20k + {CROWD_OBJECTS} x 500 splat scene at K = "
          f"{CROWD_OBJECTS + 1}, rasterize_fn=rasterize_reference {golden_s:.3f} s against the "
          f"kernel: JSON bytes equal, worst rgb {worst['rgb_db']:.2f} dB, masks "
          f"{100 * worst['mask']:.4f} % of pixels, depth within 1 mm on "
          f"{100 * worst['depth_1mm']:.4f} % card={card}", flush=True)
    return worst


def crowded_scene_phase(tmp: Path, device, card: str) -> dict:
    """Phase 18: a crowded scene, 48 objects (K = 49), on the main path and
    against the plain versions and the golden."""
    import numpy as np
    import torch

    from pegasus_tpu_torch.assets.rosters import CUP_NOODLE_CLASSES, ENV_CLASSES, YCB_CLASSES
    from pegasus_tpu_torch.physics import rigid_body as rb
    from pegasus_tpu_torch.scene.composition import pose_scene
    from pegasus_tpu_torch.testing import build_roster_dataset

    t0 = time.perf_counter()
    data, out = tmp / "crowded_data", tmp / "crowded_out"
    envs, objs = build_roster_dataset(data, list(ENV_CLASSES.values())[:1],
                                      list(YCB_CLASSES.values()) + list(CUP_NOODLE_CLASSES.values()),
                                      env_splats=CROWD_ENV_SPLATS, obj_splats=CROWD_OBJ_SPLATS)
    require(len(objs) == 51, len(objs))
    for env in envs:
        env.DROP_REGION, env.DROP_HEIGHT = CROWD_DROP_REGION, CROWD_DROP_HEIGHT
    t_assets = time.perf_counter() - t0
    gen = crowded_generation(data, out, envs, objs, device, card)
    rb.clear_step_programs()

    peg = roster_replay(data, out, "crowded_replay", envs, objs, gen["physics_file"], gen["env"], 2, device)
    drop = peg.trajectory.times_t
    require(bool(np.isfinite(drop).all()) and float(np.abs(drop).max()) < 2.0,
            f"the static drop left the scene: max |position| {float(np.abs(drop).max())} m")
    scene = pose_scene(peg.template, *peg._body_poses_at(peg._initial_step))
    require(scene.num_splats == CROWD_ENV_SPLATS + CROWD_OBJECTS * CROWD_OBJ_SPLATS, scene.num_splats)
    cams = list(peg.viewport_cam_list)
    cloud_210k = bench_scenes(device, ("210k",))["210k"]
    kernels = crowded_kernel_checks(scene, cams, cloud_210k, device, card)
    del scene, cloud_210k, peg
    torch.cuda.empty_cache()
    golden = crowded_golden_case(tmp, out, gen["physics_file"], gen["env"], device, card)
    wall = time.perf_counter() - t0
    print(f"phase 18: {wall:.1f} s (assets {t_assets:.1f} s) card={card}", flush=True)
    return {"launches": gen["launches"], "generation": gen, "kernels": kernels, "golden": golden}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also time simulate_variants(1000) in phase 9")
    parser.add_argument("--from-phase", type=int, default=1, metavar="N",
                        help="skip phases 3 to N - 1 (N > 3); such a run prints no result lines; "
                             "12 runs the build, the compact-readback case and phases 12-18, "
                             "16 the build and phases 16-18, 17 the build and phases 17-18, "
                             "18 the build and phase 18")
    args = parser.parse_args()
    t_start = time.perf_counter()
    whole = args.from_phase <= 3
    import torch

    n_packages = port_imports_leave_cuda_alone()
    print(f"import pegasus_tpu_torch and its {n_packages - 1} subpackages: "
          f"torch.cuda.is_initialized() {torch.cuda.is_initialized()}", flush=True)
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
    if whole:
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
        if whole:
            from pegasus_tpu_torch.ops.binning import bin_splats

            rasterize_cuda.composite_tiles.launches = bin_splats.host_reads = 0
            main_path = main_path_phase(data, out, dev, card)
            gen_launches = rasterize_cuda.composite_tiles.launches
            require(gen_launches == main_path["chunks"] and bin_splats.host_reads == gen_launches,
                    f"composite_tiles launched {gen_launches} times, bin_splats read the host "
                    f"{bin_splats.host_reads} times for {main_path['chunks']} chunks")
            print(f"main path: {main_path['frames']} frames in {main_path['chunks']} chunks, "
                  f"{gen_launches} forward-kernel launches, cpus={len(os.sched_getaffinity(0))}",
                  flush=True)
            chunk_k1 = chunk_kernel_check(data, out, dev, card)
            stage_times(data, out, dev, card)
            torch.cuda.empty_cache()
        if whole or args.from_phase == 12:
            compact_launches = compact_readback_case(data, out, dev, card)
        if whole:
            # -- phase 7: backward kernel vs plain ----------------------------------------------
            from pegasus_tpu_torch.ops.binning import bin_splats
            from pegasus_tpu_torch.ops.projection import project_gaussians

            bins = bin_splats(project_gaussians(train_box_cloud(dev), train_camera(dev)),
                              TRAIN_SIZE, TRAIN_SIZE)
            bwd_train = backward_vs_plain("train 150k box 512x512 K=1", bins, TRAIN_SIZE, TRAIN_SIZE, 1, card)
            scatter = scatter_to_splats("train 150k box 512x512", bins, card)
            bins = bin_splats(project_gaussians(scene_210k, cams["orbit"]), WIDTH, HEIGHT)
            bwd_210k = backward_vs_plain("210k orbit 640x480 K=7", bins, WIDTH, HEIGHT, max_objects, card)
            del bins, scene_210k
            stress = [long_segment_stress(dev, k, card) for k in (1, max_objects)]
            torch.cuda.empty_cache()

            # -- phase 8: the training main path ----------------------------------------------------
            train_launches = training_main_path(Path(tmp), dev, card)

        # -- phase 9: physics on the card ---------------------------------------------------------
        if args.from_phase <= 9:
            physics_on_card(data, out, dev, card, args.profile)
        # -- phase 10: the generation main path with physics --------------------------------------
        if args.from_phase <= 10:
            loop_launches = generation_with_physics(data, out, dev, card)
        # -- phase 11: scene variants ---------------------------------------------------------------
        if args.from_phase <= 11:
            variant_launches = scene_variants(dev, card)
        if args.from_phase <= 15:
            # -- phase 12: the splat-sharded render ---------------------------------------------------
            sharded_launches = sharded_render_phase(dev, card, max_objects)
            torch.cuda.empty_cache()
            # -- phase 13: sharded generation -----------------------------------------------------------
            sharded_gen_launches = sharded_generation_phase(data, out, dev, card)
            # -- phase 14: the data-parallel train step ---------------------------------------------------
            dp_launches = dp_step_phase(dev, card)
            torch.cuda.empty_cache()
            # -- phase 15: the full-roster dress rehearsal --------------------------------------------------
            rehearsal_launches = dress_rehearsal_phase(Path(tmp), dev, card)
            torch.cuda.empty_cache()
        # -- phase 16: asset building and viewing -----------------------------------------------------------
        if args.from_phase <= 16:
            periphery = asset_and_viewing_phase(Path(tmp), data, out, dev, card)
            torch.cuda.empty_cache()
        # -- phase 17: the renderer seam ----------------------------------------------------------------------
        if args.from_phase <= 17:
            seam = renderer_seam_phase(Path(tmp), data, out, dev, card, max_objects)
            torch.cuda.empty_cache()
        # -- phase 18: a crowded scene (K = 49) --------------------------------------------------------------
        crowded = crowded_scene_phase(Path(tmp), dev, card)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    if not whole:
        print(f"partial run from phase {args.from_phase}: no result lines", flush=True)
        return 0
    print(json.dumps({"kernels": [{
        "name": "composite_tiles",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/composite_tiles.cu",
        "replaces": "pegasus_tpu/ops/rasterize_pallas.py:531",
        "launches": (gen_launches + compact_launches + train_launches["forward"] + loop_launches
                     + variant_launches + sharded_launches + sharded_gen_launches
                     + dp_launches["forward"] + rehearsal_launches
                     + sum(periphery["forward"].values()) + seam["forward"]
                     + crowded["launches"]),
        "launches_generation": gen_launches,
        "launches_compact_readback": compact_launches,
        "launches_training": train_launches["forward"],
        "launches_scene_loop": loop_launches,
        "launches_scene_variants": variant_launches,
        "launches_sharded_render": sharded_launches,
        "launches_sharded_generation": sharded_gen_launches,
        "launches_dp_step": dp_launches["forward"],
        "launches_dress_rehearsal": rehearsal_launches,
        "launches_reconstruction": periphery["forward"]["reconstruction"],
        "launches_gui": periphery["forward"]["gui"],
        "launches_render_wrappers": periphery["forward"]["render_wrappers"],
        "launches_renderer_seam": seam["forward"],
        "launches_crowded": crowded["launches"],
        "max_abs_err": max(max_abs_err, bwd_train["fwd_max_abs_err"], bwd_210k["fwd_max_abs_err"],
                           chunk_k1["max_abs_err"], seam["render"]["max_abs_err"],
                           crowded["kernels"]["fwd_max_abs_err"], *(f for f, _ in stress)),
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
        # one launch over the main path's chunk of 8 frames (phase 5's static scene)
        "frames_chunk": chunk_k1["frames"],
        "ms_chunk": chunk_k1["ms"],
        "frames_ms_chunk": chunk_k1["frames_ms"],
        "plain_ms_chunk": chunk_k1["plain_ms"],
        "bound_ms_chunk": chunk_k1["bound_ms"],
        "bound_by_chunk": chunk_k1["bound_by"],
        "ms_train": bwd_train["fwd_ms"],
        "plain_ms_train": bwd_train["fwd_plain_ms"],
        "bound_ms_train": bwd_train["fwd"][0],
        # the 210k orbit view's bins capped at 1024 entries per tile (rasterize_tiled)
        "ms_capped": seam["render"]["ms"],
        "plain_ms_capped": seam["render"]["plain_ms"],
        "bound_ms_capped": seam["render"]["bound_ms"],
        "bound_by_capped": seam["render"]["bound_by"],
        "entries_dropped_capped": seam["render"]["dropped"],
        # a frame of the crowded scene (phase 18) at K = 49, and at K = 7 with its ids folded
        "ms_k49": crowded["kernels"]["k"][49]["fwd_ms"],
        "plain_ms_k49": crowded["kernels"]["k"][49]["fwd_plain_ms"],
        "bound_ms_k49": crowded["kernels"]["k"][49]["fwd"][0],
        "bound_by_k49": crowded["kernels"]["k"][49]["fwd"][1],
        "ms_k7_crowded_view": crowded["kernels"]["k"][7]["fwd_ms"],
        "bound_ms_k7_crowded_view": crowded["kernels"]["k"][7]["fwd"][0],
        "ms_chunk_k49": crowded["kernels"]["chunk_ms"],
        "bound_ms_chunk_k49": crowded["kernels"]["chunk_bound"][0],
    }, {
        "name": "composite_tiles_backward",
        "route": "cuda",
        "source": "pegasus_tpu_torch/csrc/composite_tiles_bwd.cu",
        "replaces": "pegasus_tpu/ops/pallas_vjp.py:105",
        "launches": (train_launches["backward"] + dp_launches["backward"]
                     + sum(periphery["backward"].values()) + seam["backward"]),
        "launches_training": train_launches["backward"],
        "launches_dp_step": dp_launches["backward"],
        "launches_reconstruction": periphery["backward"]["reconstruction"],
        "launches_gui": periphery["backward"]["gui"],
        "launches_render_wrappers": periphery["backward"]["render_wrappers"],
        "launches_renderer_seam": seam["backward"],
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
        "scatter_ms": scatter["ms"],
        "max_abs_err_k49": crowded["kernels"]["k"][49]["max_abs_err"],
        "min_cosine_k49": min(crowded["kernels"]["k"][k]["min_cosine"] for k in (33, 49)),
        "ms_k49": crowded["kernels"]["k"][49]["ms"],
        "plain_ms_k49": crowded["kernels"]["k"][49]["plain_ms"],
        "bound_ms_k49": crowded["kernels"]["k"][49]["bwd"][0],
        "bound_by_k49": crowded["kernels"]["k"][49]["bwd"][1],
        "ms_k7_crowded_view": crowded["kernels"]["k"][7]["ms"],
        "bound_ms_k7_crowded_view": crowded["kernels"]["k"][7]["bwd"][0],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
