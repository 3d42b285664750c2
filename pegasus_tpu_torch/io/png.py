"""Copied verbatim from ``pegasus_tpu/io/png.py``; only the import lines differ.

PNG writing: native zlib encoder with Python fallback.

Loads the C++ encoder (csrc/pngio.cpp) via ctypes, building it on first
use if the shared object is missing.  The native path releases the GIL for
the entire encode+write, so the dataset writer's thread pool parallelizes
across cores; falls back to imageio when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_LIB_FAILED = False
_SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
_SO_PATH = _SRC_DIR / "libpegasus_pngio.so"


def _load_native():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        if not _SO_PATH.exists():
            subprocess.run(
                ["make", "-C", str(_SRC_DIR)],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(str(_SO_PATH))
        lib.png_write_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.png_write_file.restype = ctypes.c_int
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


def write_png(path, image: np.ndarray, compression: int = 4) -> None:
    """Write uint8 gray/RGB/RGBA or uint16 gray PNGs."""
    image = np.ascontiguousarray(image)
    if image.ndim == 2:
        channels = 1
    elif image.ndim == 3 and image.shape[2] in (1, 3, 4):
        channels = image.shape[2]
        if channels == 1:
            image = image[:, :, 0]
    else:
        raise ValueError(f"unsupported image shape {image.shape}")

    if image.dtype == np.uint8:
        bit_depth = 8
    elif image.dtype == np.uint16:
        bit_depth = 16
        if channels != 1:
            raise ValueError("16-bit PNGs are single-channel (BOP depth)")
    else:
        raise ValueError(f"unsupported dtype {image.dtype}")

    lib = _load_native()
    if lib is not None:
        h, w = image.shape[:2]
        buf = image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rc = lib.png_write_file(
            str(path).encode(), buf, w, h, channels, bit_depth, compression
        )
        if rc == 0:
            return
        # fall through on any native error

    import imageio.v2 as imageio

    imageio.imwrite(str(path), image)
