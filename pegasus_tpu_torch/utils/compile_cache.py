"""The kernels' build cache for generation and training entry points.

Port of ``pegasus_tpu/utils/compile_cache.py``.  The JAX package persists
XLA executables across processes so that a resumed run skips its one-time
compiles.  The port's one-time compile is the ``nvcc`` build of the
compositor kernels, which ``ops/rasterize_cuda.build_kernel`` already keeps
in a build directory under a digest of the sources and flags; this module
is its switch, with the reference's contract.

``PEGASUS_TPU_COMPILE_CACHE``: ``0`` disables the cache (each process builds
its kernels afresh, reusing no library an earlier process built), any other
value moves the build directory (default ``pegasus_tpu_torch/csrc/build/``).
A kernel is always built before it runs: where the directory cannot be
written, the default build directory stays in use and stderr says so.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

_enabled = False


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Point the kernels' build cache at ``path`` (or the variable's
    directory, or the default).

    Idempotent: only the first call of a process acts, later ones return
    None.  Returns the build directory in use, or None when disabled
    (``PEGASUS_TPU_COMPILE_CACHE=0``) or the directory is not writable."""
    global _enabled
    if _enabled:
        return None
    _enabled = True  # one attempt per process, even on failure
    from pegasus_tpu_torch.ops import rasterize_cuda

    env = os.environ.get("PEGASUS_TPU_COMPILE_CACHE", "")
    if env == "0":
        rasterize_cuda._REUSE_BUILDS = False
        return None
    cache_dir = path or (env if env not in ("", "1") else None) or str(rasterize_cuda.DEFAULT_BUILD_DIR)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        writable = os.access(cache_dir, os.W_OK)
    except OSError:
        writable = False
    if not writable:
        print(f"enable_compilation_cache: {cache_dir} is not writable; the kernels build in "
              f"{rasterize_cuda._BUILD_DIR}", file=sys.stderr)
        return None
    rasterize_cuda._BUILD_DIR = Path(cache_dir)
    return cache_dir
