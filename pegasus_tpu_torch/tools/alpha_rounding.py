"""What the rounding of the compositor's alpha expression costs, and what it decides.

    python3 -m pegasus_tpu_torch.tools.alpha_rounding   (repository root, one GPU)

The forward kernel ``csrc/composite_tiles.cu`` and its backward
``csrc/composite_tiles_bwd.cu`` both inline ``entry_alpha()``
(``csrc/composite_common.cuh``), and must agree on every kept (pixel,
entry) pair.  This script builds the forward kernel three times, with the
quadratic form and the opacity product of ``entry_alpha()`` written as

* ``rn``: ``__fmul_rn`` / ``__fadd_rn`` products and sums, which nvcc never
  contracts;
* ``fma``: explicit ``__fmaf_rn`` in a fixed order, which nvcc neither splits
  nor re-fuses;
* ``plain``: plain float expressions, which nvcc contracts into FMAs as it
  sees fit in each kernel that inlines them,

and times the three on the same bins (the 210k and 1M bench scenes at the
orbit view, K = 7, and the training shape, K = 1) in the order rn, fma,
plain, plain, fma, rn.  A diagnostic kernel then walks every in-image
pixel-entry pair of those bins and of the grazing views, evaluates the
three forms side by side and counts the pairs on which ``plain`` or
``fma`` keeps differently from ``rn``, or differs on the 0.99 clamp of a
kept pair (the backward's gate on the mean, conic and opacity rows).  Where
nvcc contracts ``plain`` in the diagnostic kernel differently from the
compositor, the counts are of the diagnostic kernel's form.

Prints one line per shape and, last, one JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the body of entry_alpha() from the quadratic form to the opacity product
_BODY = re.compile(r"  const float (?:quad|power) = .*?  raw = [^\n]*\n", re.S)
_BODIES = {
    "rn": (
        "  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy));\n"
        "  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));\n"
        "  exppow = expf(fminf(power, 0.f));\n"
        "  raw = __fmul_rn(opac, exppow);\n"
    ),
    "fma": (
        "  const float quad = __fmaf_rn(__fmul_rn(cc, dy), dy, __fmul_rn(__fmul_rn(ca, dx), dx));\n"
        "  const float power = __fmaf_rn(-__fmul_rn(cb, dx), dy, __fmul_rn(-0.5f, quad));\n"
        "  exppow = expf(fminf(power, 0.f));\n"
        "  raw = __fmul_rn(opac, exppow);\n"
    ),
    "plain": (
        "  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;\n"
        "  exppow = expf(fminf(power, 0.f));\n"
        "  raw = opac * exppow;\n"
    ),
}
VARIANTS = ("rn", "fma", "plain")

# counts[0] in-image pairs; per variant v in (fma, plain): keep differs from
# rn, and kept by both but the clamp (raw < 0.99) differs
_DIAG = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#define entry_alpha entry_alpha_rn
#include "rn/composite_common.cuh"
#undef entry_alpha
#define composite composite_fma
#define entry_alpha entry_alpha_fma
#include "fma/composite_common.cuh"
#undef entry_alpha
#undef composite
#define composite composite_plain
#define entry_alpha entry_alpha_plain
#include "plain/composite_common.cuh"
#undef entry_alpha
#undef composite

namespace {
using namespace composite;

__global__ void __launch_bounds__(PX)
alpha_flips_kernel(const float* __restrict__ params, int64_t n, const int* __restrict__ entry_splat,
                   const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                   int width, int height, int ntx, unsigned long long* counts) {
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int px = (tile % ntx) * TILE + tid % TILE, py = (tile / ntx) * TILE + tid / TILE;
  if (px >= width || py >= height) return;
  const float fx = static_cast<float>(px), fy = static_cast<float>(py);
  unsigned long long c[5] = {0, 0, 0, 0, 0};
  for (int e = tile_start[tile]; e < tile_start[tile] + tile_count[tile]; ++e) {
    const int64_t s = entry_splat[e];
    const float mx = params[P_MX * n + s], my = params[P_MY * n + s];
    const float ca = params[P_CA * n + s], cb = params[P_CB * n + s], cc = params[P_CC * n + s];
    const float op = params[P_OPAC * n + s], rad = params[P_RADIUS * n + s];
    float dx, dy, ep, raw[3], a;
    bool keep[3];
    keep[0] = entry_alpha_rn(fx, fy, mx, my, ca, cb, cc, op, rad, dx, dy, ep, raw[0], a);
    keep[1] = composite_fma::entry_alpha_fma(fx, fy, mx, my, ca, cb, cc, op, rad, dx, dy, ep, raw[1], a);
    keep[2] = composite_plain::entry_alpha_plain(fx, fy, mx, my, ca, cb, cc, op, rad, dx, dy, ep, raw[2], a);
    c[0] += 1;
    for (int v = 1; v < 3; ++v) {
      c[2 * v - 1] += keep[v] != keep[0];
      c[2 * v] += keep[v] && keep[0] && ((raw[v] < 0.99f) != (raw[0] < 0.99f));
    }
  }
  for (int i = 0; i < 5; ++i) atomicAdd(&counts[i], c[i]);
}
}  // namespace

extern "C" int alpha_flips_launch(const float* params, int64_t n, const int* entry_splat,
                                  const int* tile_start, const int* tile_count, int width,
                                  int height, int ntx, int nty, unsigned long long* counts,
                                  void* stream) {
  alpha_flips_kernel<<<ntx * nty, PX, 0, static_cast<cudaStream_t>(stream)>>>(
      params, n, entry_splat, tile_start, tile_count, width, height, ntx, counts);
  return static_cast<int>(cudaGetLastError());
}
"""


def _write_sources(root: Path) -> dict:
    """One directory per variant (the compositor and its header) and the
    diagnostic source; returns {name: source path}."""
    from pegasus_tpu_torch.ops.rasterize_cuda import _CSRC

    header = (_CSRC / "composite_common.cuh").read_text()
    if len(_BODY.findall(header)) != 1:
        raise RuntimeError("entry_alpha() in composite_common.cuh no longer has the expected form")
    sources = {}
    for v in VARIANTS:
        d = root / v
        d.mkdir(parents=True, exist_ok=True)
        body = _BODY.sub(lambda _: _BODIES[v], header)
        (d / "composite_common.cuh").write_text(body)
        (d / "composite_tiles.cu").write_text((_CSRC / "composite_tiles.cu").read_text())
        sources[v] = d / "composite_tiles.cu"
    (root / "alpha_flips.cu").write_text(_DIAG)
    sources["diag"] = root / "alpha_flips.cu"
    return sources


def _build(src: Path) -> ctypes.CDLL:
    from pegasus_tpu_torch.ops.rasterize_cuda import _NVCC_FLAGS, _find_nvcc

    lib = src.with_suffix(".so")
    proc = subprocess.run([_find_nvcc(src.name), *_NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _launcher(lib: ctypes.CDLL):
    import torch

    from pegasus_tpu_torch.ops.rasterize_cuda import num_channels

    fn = lib.composite_tiles_launch
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, i64, p, p, p, p, i32, i32, i32, i32, i32, p]
    fn.restype = ctypes.c_int

    def run(bins, width, height, k):
        out = torch.empty((height, width, num_channels(k)), device=bins.params.device)
        err = fn(bins.params.data_ptr(), bins.params.shape[1], bins.entry_splat.data_ptr(),
                 bins.tile_start.data_ptr(), bins.tile_count.data_ptr(), out.data_ptr(),
                 width, height, bins.n_tiles_x, bins.n_tiles_y, k,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"composite_tiles launch failed: CUDA error {err}")
        return out

    return run


def _flips(lib: ctypes.CDLL, bins, width, height) -> dict:
    import torch

    fn = lib.alpha_flips_launch
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, i64, p, p, p, i32, i32, i32, i32, p, p]
    fn.restype = ctypes.c_int
    counts = torch.zeros(5, dtype=torch.int64, device=bins.params.device)
    err = fn(bins.params.data_ptr(), bins.params.shape[1], bins.entry_splat.data_ptr(),
             bins.tile_start.data_ptr(), bins.tile_count.data_ptr(), width, height,
             bins.n_tiles_x, bins.n_tiles_y, counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"alpha_flips launch failed: CUDA error {err}")
    c = counts.tolist()
    return {"pairs": c[0], "keep_fma": c[1], "clamp_fma": c[2], "keep_plain": c[3], "clamp_plain": c[4]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("alpha_rounding: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from pegasus_tpu_torch.ops.binning import bin_splats
    from pegasus_tpu_torch.ops.projection import project_gaussians
    from pegasus_tpu_torch.ops.rasterize_cuda import _BUILD_DIR

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    sources = _write_sources(_BUILD_DIR / "alpha_rounding")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build, sources.values())))
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    run = {v: _launcher(libs[v]) for v in VARIANTS}

    dev = torch.device("cuda:0")
    k_bench = 7
    scenes = smoke.bench_scenes(dev)
    cams = smoke.bench_cameras(dev)
    shapes = [(f"{s} {c}", scenes[s], cams[c], smoke.WIDTH, smoke.HEIGHT, k_bench, c == "orbit")
              for s in scenes for c in cams]
    shapes.append(("train 150k box", smoke.train_box_cloud(dev), smoke.train_camera(dev),
                   smoke.TRAIN_SIZE, smoke.TRAIN_SIZE, 1, True))
    report = {"card": card, "shapes": {}}
    for label, cloud, cam, w, h, k, timed in shapes:
        bins = bin_splats(project_gaussians(cloud, cam), w, h)
        row = {"entries": bins.entry_splat.numel(), **_flips(libs["diag"], bins, w, h)}
        outs = {v: run[v](bins, w, h, k) for v in VARIANTS}
        row["max_abs_out_diff"] = {v: float((outs[v] - outs["rn"]).abs().max()) for v in VARIANTS[1:]}
        if timed:
            order = VARIANTS + VARIANTS[::-1]
            runs = [(v, smoke.cuda_ms(lambda v=v: run[v](bins, w, h, k), 20)) for v in order]
            row["runs_ms"] = runs
            row["ms"] = {v: min(t for u, t in runs if u == v) for v in VARIANTS}
        report["shapes"][label] = row
        print(f"{label}: {json.dumps(row)} card={card}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
