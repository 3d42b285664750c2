"""Copied verbatim from ``pegasus_tpu/io/zbuffer.py``; only the import lines differ.

Native z-buffer mesh depth rendering (ctypes over csrc/zbuffer.cpp).

The BOP vsd metric renders the model's depth twice per pose hypothesis
(reference: bop_toolkit_lib/pose_error.py:17-95 via the C++ renderer,
bop_toolkit_lib/renderer_cpp.py:17).  eval.py's NumPy z-buffer has the
same semantics but loops triangles in Python; this binding loads the
native twin — identical bbox / inclusive-edge / perspective-correct-1/z
rules in double precision — and releases the GIL for the whole render.
Callers fall back to the NumPy path when no compiler is available.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_LIB_FAILED = False
_SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
_SO_PATH = _SRC_DIR / "libpegasus_zbuffer.so"


def _load_native():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        if not _SO_PATH.exists():
            subprocess.run(
                ["make", "-C", str(_SRC_DIR)], check=True, capture_output=True
            )
        lib = ctypes.CDLL(str(_SO_PATH))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.zbuffer_render_depth.argtypes = [
            dp, ctypes.c_int,                          # vertices, n_verts
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # faces, n_faces
            dp, dp, dp,                                # R, t, K
            ctypes.c_int, ctypes.c_int,                # width, height
            dp,                                        # depth out
        ]
        lib.zbuffer_render_depth.restype = ctypes.c_int
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


def available() -> bool:
    return _load_native() is not None


def render_depth(vertices, faces, R, t, K, width: int, height: int):
    """[H, W] float64 z-depth (0 = background) of a posed mesh, or None
    if the native library cannot be built/loaded."""
    lib = _load_native()
    if lib is None:
        return None
    verts = np.ascontiguousarray(vertices, np.float64)
    tris = np.ascontiguousarray(faces, np.int32)
    Rm = np.ascontiguousarray(R, np.float64).reshape(9)
    tv = np.ascontiguousarray(t, np.float64).reshape(3)
    Km = np.ascontiguousarray(K, np.float64).reshape(9)
    depth = np.zeros((height, width), np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.zbuffer_render_depth(
        verts.ctypes.data_as(dp), len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris),
        Rm.ctypes.data_as(dp), tv.ctypes.data_as(dp), Km.ctypes.data_as(dp),
        width, height,
        depth.ctypes.data_as(dp),
    )
    if rc != 0:
        return None
    return depth
