"""Renderer backend self-validation (PSNR gates as a library call).

Port of ``pegasus_tpu/ops/validate.py``.  Renderer parity is gated at PSNR
> 40 dB against the golden compositor on composed scenes; this utility runs
the same gate on a caller's scene and backend:

    from pegasus_tpu_torch.ops.validate import compare_backends
    report = compare_backends(scene, cam, max_objects=8)
    assert report["pass_40db"]

The backends are the reference's ``"auto"`` (the default), ``"pallas"``
and ``"tiled"``, and the port's ``"cuda"`` and ``"sharded"``: ``"auto"``,
``"pallas"`` and ``"cuda"`` are ``rasterize`` (the tile compositor kernel on
the card, its plain version on the CPU, as the tensors' device decides),
``"tiled"`` is ``ops.rasterize_tiled.rasterize_tiled`` (the same compositor
on bins capped at ``max_per_tile``) and ``"sharded"`` the splat-sharded
render over ``mesh=``.  The report names ``"auto"`` as ``"cuda"``.
"""

from __future__ import annotations

import numpy as np
import torch

from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.gs.cloud import GaussianCloud
from pegasus_tpu_torch.ops.rasterize_ref import RenderOutputs


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def psnr_db(a, b, peak: float = 1.0) -> float:
    mse = float(np.mean((_np(a) - _np(b)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak**2 / mse)


def compare_outputs(ref, out) -> dict:
    """Two RenderOutputs -> per-channel PSNR (depth against the reference's
    peak), max |diff| per field and mask agreement at the 0.9 threshold."""
    depth_peak = max(float(_np(ref.depth).max()), 1e-6)
    report = {}
    for name in RenderOutputs._fields:
        a, b = _np(getattr(ref, name)), _np(getattr(out, name))
        peak = depth_peak if name == "depth" else 1.0
        report[f"{name}_psnr_db"] = psnr_db(a, b, peak=peak)
        report[f"{name}_max_err"] = float(np.abs(a - b).max())
        if name in ("seg_weights", "vis_weights", "amodal"):
            report[f"{name}_mask_disagree"] = float(np.mean((a >= 0.9) != (b >= 0.9)))
    report["min_psnr_db"] = min(v for k, v in report.items() if k.endswith("_psnr_db"))
    report["pass_40db"] = report["min_psnr_db"] > 40.0
    return report


def compare_backends(
    scene: GaussianCloud,
    cam: Camera,
    backend: str = "auto",
    max_objects: int = 8,
    background=(0.0, 0.0, 0.0),
    **backend_kwargs,
) -> dict:
    """Render ``scene`` with the golden compositor and the chosen fast
    backend; return per-channel PSNR and mask agreement.  ``"tiled"``
    takes ``rasterize_tiled``'s options (``max_per_tile=``), ``"sharded"``
    takes ``mesh=`` (and ``rasterize_splat_sharded``'s other options)."""
    from pegasus_tpu_torch.ops.rasterize_ref import rasterize_reference

    if backend == "auto":
        backend = "cuda"
    if backend in ("cuda", "pallas"):
        from pegasus_tpu_torch.ops.rasterize_cuda import rasterize as fast
    elif backend == "tiled":
        from pegasus_tpu_torch.ops.rasterize_tiled import rasterize_tiled as fast
    elif backend == "sharded":
        from pegasus_tpu_torch.parallel.sharded_render import rasterize_splat_sharded as fast
    else:
        raise ValueError(f"unknown backend {backend}")

    with torch.no_grad():
        ref = rasterize_reference(scene, cam, background=background, max_objects=max_objects)
        out = fast(scene, cam, background=background, max_objects=max_objects, **backend_kwargs)
    return {"backend": backend, **compare_outputs(ref, out)}
