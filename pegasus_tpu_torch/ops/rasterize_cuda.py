"""Tile-compositing rasterizer: project -> exact bin -> CUDA composite.

Replaces ``pegasus_tpu/ops/rasterize_pallas.py`` (``rasterize_pallas`` and
``composite_tiles_pallas``).  ``composite_tiles`` launches the hand-written
sm_90a kernel ``csrc/composite_tiles.cu`` for CUDA tensors and runs its
plain torch version, ``composite_tiles_torch``, for CPU tensors; there is
no fallback from one to the other.  The TPU knobs are dropped:
``tiles_per_program``, ``chunk``, ``pack_params`` and the binning
budgets / caps exist for Mosaic's static shapes and VMEM windows
(rasterize_pallas.py:379-528), and exact binning has none of them.

Source note for the kernel (what bounds it on an H100 and what the design
does about it) is at the top of ``csrc/composite_tiles.cu``.  The kernel
cuts every tile's segment into work items of at most ``CHUNK_ENTRIES``
entries, one block each, and combines the items of a tile in order; the
plain version composites and combines with the same association, so the
CPU tests exercise the combine too.

Output channels of both versions, per pixel ([H, W, F], F = 5 + 3K + 2):
  0:3 rgb (premultiplied, no background), 3 depth, 4 alpha, 5:5+K seg,
  5+K:5+2K vis (environment excluded), 5+2K:5+3K amodal log-transmittance,
  5+3K t_full, 5+3K+1 t_noenv.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.ops import binning as B
from pegasus_tpu_torch.ops.binning import TileBins, bin_splats
from pegasus_tpu_torch.ops.projection import project_gaussians
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs

MAX_OBJECTS_LIMIT = 32  # the kernel's largest register-resident K
# Entries per work item, C: segments longer than this are split across
# blocks.  At the 210k-splat orbit view (mean 466 entries per tile, p99
# 4,359, max 5,738) C = 256 makes 2,874 items of 1,200 tiles, and at the
# training shape (mean 408, max 2,875) 2,532 of 1,024.  chip_smoke.py times
# both kernels at C = 128, 256, 512 and 1024; PERF.md has the times and
# why 256.
CHUNK_ENTRIES = 256

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = _CSRC / "build"
# no --use_fast_math: the backward must recompute the forward's alphas exactly
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIBS: dict[str, ctypes.CDLL] = {}  # source file name -> loaded library


def num_channels(max_objects: int) -> int:
    return 5 + 3 * max_objects + 2


def _find_nvcc(source: str) -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (PATH or $CUDA_HOME/bin): cannot build {source}"
        )
    return nvcc


def build_kernel(source: str = "composite_tiles.cu") -> tuple[Path, str]:
    """Compile ``csrc/<source>`` into a shared library in ``csrc/build/``,
    once per content (the source, the shared headers and the flags).
    Returns (library path, compiler log; empty if cached).  Raises if nvcc
    is missing or the build fails."""
    src = _CSRC / source
    content = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh"))
    )
    digest = hashlib.sha256(content + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_find_nvcc(source), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def kernel_lib(source: str, entry: str, argtypes: list) -> ctypes.CDLL:
    """The library built from ``csrc/<source>`` (built and loaded at first
    use), with ``entry`` declared to take ``argtypes`` and return an int
    CUDA error code."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernel(source)[0]))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
FWD_ARGTYPES = [_P, _I64, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P]


def _kernel_lib():
    return kernel_lib("composite_tiles.cu", "composite_tiles_launch", FWD_ARGTYPES)


def max_items(n_entries: int, n_tiles: int, chunk_entries: int) -> int:
    """Bound on the work items of a frame, from sizes the host knows:
    every tile holds max(1, ceil(count / C)) <= count / C + 1 items."""
    return -(-n_entries // chunk_entries) + n_tiles


def tile_items(bins: TileBins, chunk_entries: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(items per tile, index of each tile's first item), int64 [n_tiles]:
    the numbering both kernels derive on the device (composite_common.cuh)."""
    count = bins.tile_count.long()
    n = torch.where(count > chunk_entries, -(-count // chunk_entries), torch.ones_like(count))
    return n, torch.cumsum(n, 0) - n


def partials_shape(bins: TileBins, max_objects: int, chunk_entries: int) -> tuple[int, int, int]:
    """[items bound, F, 256]: one row of per-pixel partials per work item."""
    n_tiles = bins.n_tiles_x * bins.n_tiles_y
    return (max_items(bins.entry_splat.numel(), n_tiles, chunk_entries),
            num_channels(max_objects), B.TILE * B.TILE)


def launch_composite(fn, bins: TileBins, width: int, height: int, max_objects: int,
                     chunk_entries: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch a ``composite_tiles_launch`` entry point (``fn``, argtypes
    ``FWD_ARGTYPES``) on the current stream -> (out [H, W, F], partials)."""
    dev = bins.params.device
    out = torch.empty((height, width, num_channels(max_objects)), dtype=torch.float32, device=dev)
    shape = partials_shape(bins, max_objects, chunk_entries)
    partials = torch.empty(shape, dtype=torch.float32, device=dev)
    tile_done = torch.empty(bins.n_tiles_x * bins.n_tiles_y, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            bins.params.data_ptr(), bins.params.shape[1],
            bins.entry_splat.data_ptr(), bins.tile_start.data_ptr(),
            bins.tile_count.data_ptr(), out.data_ptr(), partials.data_ptr(),
            tile_done.data_ptr(), shape[0],
            width, height, bins.n_tiles_x, bins.n_tiles_y, max_objects, chunk_entries,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_tiles kernel launch failed: CUDA error {err}")
    return out, partials


def _check_bins(bins: TileBins, width: int, height: int, max_objects: int) -> None:
    if (bins.n_tiles_x, bins.n_tiles_y) != (-(-width // B.TILE), -(-height // B.TILE)):
        raise ValueError(
            f"bins cover {bins.n_tiles_x}x{bins.n_tiles_y} tiles, not a {width}x{height} image"
        )
    if not 1 <= max_objects <= MAX_OBJECTS_LIMIT:
        raise ValueError(
            f"max_objects={max_objects} outside 1..{MAX_OBJECTS_LIMIT} "
            "(the compositor keeps K accumulators in registers)"
        )
    if bins.max_object_id >= max_objects:
        raise ValueError(
            f"object id {bins.max_object_id} >= max_objects={max_objects}: "
            "its seg/vis/amodal channel would be dropped"
        )
    n_tiles = bins.n_tiles_x * bins.n_tiles_y
    expect = {
        "params": (bins.params, torch.float32, (B.PARAM_DIM, bins.params.shape[1])),
        "entry_splat": (bins.entry_splat, torch.int32, (bins.entry_splat.numel(),)),
        "tile_start": (bins.tile_start, torch.int32, (n_tiles,)),
        "tile_count": (bins.tile_count, torch.int32, (n_tiles,)),
    }
    dev = bins.params.device
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, params on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )


def composite_tiles(
    bins: TileBins, width: int, height: int, max_objects: int,
    chunk_entries: int = CHUNK_ENTRIES, return_partials: bool = False,
):
    """Composite every tile's entries front to back -> [H, W, F] float32,
    or (out, partials) with ``return_partials``: the per-item partials
    ``composite_tiles_backward`` needs (rows of tiles of more than one item;
    shape ``partials_shape``).

    CPU tensors run ``composite_tiles_torch``; CUDA tensors launch the
    kernel on the current stream (built at first use) or raise."""
    _check_bins(bins, width, height, max_objects)
    if chunk_entries < 1:
        raise ValueError(f"chunk_entries={chunk_entries} < 1")
    if bins.params.device.type == "cpu":
        return composite_tiles_torch(bins, width, height, max_objects,
                                     chunk_entries=chunk_entries, return_partials=return_partials)
    if bins.params.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {bins.params.device}")
    out, partials = launch_composite(_kernel_lib().composite_tiles_launch, bins, width, height,
                                     max_objects, chunk_entries)
    composite_tiles.launches += 1
    return (out, partials) if return_partials else out


composite_tiles.launches = 0


class TileChunk(NamedTuple):
    """One step of the plain versions: entries [lo, lo + C) of every tile
    still holding that many, and each (pixel, entry) pair's alpha."""

    lo: int  # first entry of the step, counted from each tile's start
    act: torch.Tensor  # [A] tiles with entries left
    ok: torch.Tensor  # [A, C] the entry exists
    idx: torch.Tensor  # [A, C] its index in entry_splat (0 where not ok)
    p: torch.Tensor  # [PARAM_DIM, A, C] its splat's parameters
    px: torch.Tensor  # [A, PX] pixel x (int64)
    py: torch.Tensor  # [A, PX] pixel y
    dx: torch.Tensor  # [A, PX, C] pixel - mean
    dy: torch.Tensor
    exppow: torch.Tensor  # exp(min(power, 0))
    raw: torch.Tensor  # opacity * exppow, before the 0.99 clamp
    alpha: torch.Tensor  # min(raw, 0.99)
    keep: torch.Tensor  # the kernels' keep rule, and ok


def tile_chunks(bins: TileBins, chunk: int, chunk_entries: int | None = None):
    """Walk every tile's segment ``chunk`` entries at a time, vectorised
    over tiles, with the kernels' alpha expressions (composite_common.cuh:
    the same products and sums, left to right).  With ``chunk_entries`` no
    step crosses a work item's boundary (a multiple of it)."""
    dev = bins.params.device
    ntx, n_tiles = bins.n_tiles_x, bins.n_tiles_x * bins.n_tiles_y
    lin = torch.arange(B.TILE * B.TILE, device=dev)
    tiles = torch.arange(n_tiles, device=dev)
    pxs = (tiles % ntx)[:, None] * B.TILE + lin % B.TILE
    pys = (tiles // ntx)[:, None] * B.TILE + lin // B.TILE
    start = bins.tile_start.long()
    count = bins.tile_count.long()
    entry_splat = bins.entry_splat.long()
    max_count = int(count.max()) if n_tiles else 0
    lo = 0
    while lo < max_count:
        width = chunk
        if chunk_entries is not None:
            width = min(chunk, (lo // chunk_entries + 1) * chunk_entries - lo)
        act = torch.nonzero(count > lo)[:, 0]
        e = lo + torch.arange(width, device=dev)
        ok = e[None, :] < count[act, None]  # [A, C]
        idx = torch.where(ok, start[act, None] + e[None, :], 0)
        p = bins.params[:, entry_splat[idx]]  # [F, A, C]
        px, py = pxs[act], pys[act]
        dx = px.to(torch.float32)[:, :, None] - p[B.P_MX][:, None, :]  # [A, PX, C]
        dy = py.to(torch.float32)[:, :, None] - p[B.P_MY][:, None, :]
        ca, cb, cc = (p[r][:, None, :] for r in (B.P_CA, B.P_CB, B.P_CC))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        exppow = torch.exp(torch.clamp(power, max=0.0))
        raw = p[B.P_OPAC][:, None, :] * exppow
        alpha = torch.clamp(raw, max=0.99)
        rad = p[B.P_RADIUS][:, None, :]
        keep = (
            (power <= 0.0) & (alpha >= 1.0 / 255.0)
            & (torch.abs(dx) <= rad) & (torch.abs(dy) <= rad) & ok[:, None, :]
        )
        yield TileChunk(lo, act, ok, idx, p, px, py, dx, dy, exppow, raw, alpha, keep)
        lo += width


def over(acc: torch.Tensor, part: torch.Tensor, k: int) -> torch.Tensor:
    """Composite ``part`` behind ``acc`` ([..., F] in the output's channel
    order, each composited from T = 1): the combine of two work items."""
    t, t_ne = acc[..., 5 + 3 * k, None], acc[..., 5 + 3 * k + 1, None]
    return torch.cat([
        acc[..., : 5 + k] + t * part[..., : 5 + k],
        acc[..., 5 + k : 5 + 2 * k] + t_ne * part[..., 5 + k : 5 + 2 * k],
        acc[..., 5 + 2 * k : 5 + 3 * k] + part[..., 5 + 2 * k : 5 + 3 * k],
        t * part[..., 5 + 3 * k, None],
        t_ne * part[..., 5 + 3 * k + 1, None],
    ], dim=-1)


def composite_tiles_torch(
    bins: TileBins, width: int, height: int, max_objects: int, chunk: int = 64,
    chunk_entries: int = CHUNK_ENTRIES, return_partials: bool = False,
):
    """Plain torch version of the kernel, same inputs and outputs.

    Vectorised over tiles (``tile_chunks``): each step composites a chunk
    of entries with an exclusive cumulative product of (1 - alpha) and
    carries the transmittances to the next step.  Like the kernel, each
    work item of ``chunk_entries`` entries composites from T = 1 and is
    combined into its tile's result in order (``over``)."""
    _check_bins(bins, width, height, max_objects)
    dev = bins.params.device
    k = max_objects
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    n_tiles = ntx * nty
    px_n = B.TILE * B.TILE

    count = bins.tile_count.long()
    multi = count > chunk_entries
    _, first = tile_items(bins, chunk_entries)
    partials = torch.zeros(partials_shape(bins, k, chunk_entries), device=dev)
    identity = torch.cat([torch.zeros(n_tiles, px_n, 5 + 3 * k, device=dev),
                          torch.ones(n_tiles, px_n, 2, device=dev)], dim=-1)
    total = identity

    def fresh():
        """The current item's state: t_full, t_ne, A and vis sums, amodal log."""
        return (torch.ones(n_tiles, px_n, device=dev), torch.ones(n_tiles, px_n, device=dev),
                torch.zeros(n_tiles, px_n, 5 + 2 * k, device=dev),
                torch.zeros(n_tiles, px_n, k, device=dev))

    def finish(item, state):
        """Item ``item`` of every tile that has it is done: keep its
        partials (tiles of several items) and combine it in order."""
        t_full, t_ne, acc, amodal_log = state
        part = torch.cat([acc, amodal_log, t_full[..., None], t_ne[..., None]], dim=-1)
        rows = multi & (count > item * chunk_entries)
        partials[first[rows] + item] = part[rows].transpose(1, 2)
        return over(total, part, k)

    kk = torch.arange(k, device=dev)
    item, state = 0, fresh()
    for c in tile_chunks(bins, chunk, chunk_entries):
        if c.lo // chunk_entries > item:
            total = finish(item, state)
            item, state = c.lo // chunk_entries, fresh()
        t_full, t_ne, acc, amodal_log = state
        act, p = c.act, c.p
        a = torch.where(c.keep, c.alpha, torch.zeros_like(c.alpha))

        obj = p[B.P_OBJ].long()  # [A, C]
        onehot = (obj[..., None] == kk).to(torch.float32)  # [A, C, K]
        feat = torch.cat(
            [p[[B.P_R, B.P_G, B.P_B, B.P_DEPTH]].permute(1, 2, 0),
             torch.ones_like(onehot[..., :1]), onehot],
            dim=-1,
        )  # [A, C, 5 + K]

        def chain(a_c, t0):
            keep_frac = torch.cumprod(1.0 - a_c, dim=-1)
            excl = torch.cat([torch.ones_like(keep_frac[..., :1]), keep_frac[..., :-1]], -1)
            return a_c * excl * t0[:, :, None], t0 * keep_frac[..., -1]

        w_full, t_full[act] = chain(a, t_full[act])
        a_ne = torch.where((obj == 0)[:, None, :], torch.zeros_like(a), a)
        w_ne, t_ne[act] = chain(a_ne, t_ne[act])
        acc[act] += torch.cat(
            [torch.bmm(w_full, feat), torch.bmm(w_ne, onehot)], dim=-1
        )
        amodal_log[act] += torch.bmm(torch.log1p(-a), onehot)
    total = finish(item, state)

    out = total.reshape(nty, ntx, B.TILE, B.TILE, -1).permute(0, 2, 1, 3, 4)
    out = out.reshape(nty * B.TILE, ntx * B.TILE, -1)[:height, :width].contiguous()
    return (out, partials) if return_partials else out


def outputs_from_channels(out: torch.Tensor, background, max_objects: int) -> RenderOutputs:
    """[H, W, F] compositor channels -> RenderOutputs, blending the
    background behind the remaining transmittance."""
    k = max_objects
    bg = torch.as_tensor(background, dtype=torch.float32, device=out.device)
    t_full = out[..., 5 + 3 * k]
    return RenderOutputs(
        rgb=out[..., 0:3] + t_full[..., None] * bg,
        depth=out[..., 3],
        alpha=out[..., 4],
        seg_weights=out[..., 5 : 5 + k],
        vis_weights=out[..., 5 + k : 5 + 2 * k],
        amodal=1.0 - torch.exp(out[..., 5 + 2 * k : 5 + 3 * k]),
    )


def rasterize(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
) -> RenderOutputs:
    """Drop-in alternative to ``rasterize_reference`` (same RenderOutputs)."""
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    bins = bin_splats(proj, cam.width, cam.height)
    out = composite_tiles(bins, cam.width, cam.height, max_objects)
    return outputs_from_channels(out, background, max_objects)
