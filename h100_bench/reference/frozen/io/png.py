"""Frozen copy of pegasus_tpu_torch/io/png.py at commit 7a69f88, the reader only: without ``write_png`` and its native encoder; cut to what the benchmark calls.

Copied verbatim from ``pegasus_tpu/io/png.py``; only the import lines differ, and ``read_png`` was added.

PNG writing: native zlib encoder with Python fallback.  PNG reading
(``read_png``): the standard library's zlib and numpy, no imageio.

Loads the C++ encoder (csrc/pngio.cpp) via ctypes, building it on first
use if the shared object is missing.  The native path releases the GIL for
the entire encode+write, so the dataset writer's thread pool parallelizes
across cores; falls back to imageio when no compiler is available.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _unfilter_sequential(kind: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    """Average (3) and Paeth (4) rows: each byte depends on the one bpp
    bytes to its left, so they are undone byte by byte."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


def read_png(path) -> np.ndarray:
    """Decode an 8- or 16-bit grey, RGB or RGBA non-interlaced PNG into uint8
    or uint16 [H, W] (grey) or [H, W, C], the layout imageio returns (the
    writer's depth PNGs are 16-bit grey).  Undoes all five row filters.
    Raises ValueError on any other PNG (palette, grey+alpha, fewer than 8
    bits, interlaced) and on a file that is not a PNG."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, bits, ctype, compression, filter_method, interlace = hdr
    if (bits not in (8, 16) or ctype not in _PNG_CHANNELS or interlace or compression
            or filter_method):
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {bits}, colour type {ctype}, "
            f"interlace {interlace}); read_png takes 8- or 16-bit grey/RGB/RGBA, non-interlaced"
        )
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * bits // 8  # the filters work on bytes, one pixel apart
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            out[y] = line
        elif kind == 1:  # Sub: a running sum per byte of the pixel, modulo 256
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        elif kind in (3, 4):  # Average, Paeth
            out[y] = np.frombuffer(
                _unfilter_sequential(kind, line.tobytes(), prev.tobytes(), bpp), np.uint8
            )
        else:
            raise ValueError(f"{path}: row {y} has unknown filter type {kind}")
        prev = out[y]
    if bits == 16:  # big-endian samples
        out = out.view(">u2").astype(np.uint16)
    img = out.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img
