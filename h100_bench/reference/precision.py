"""The control: the plain reference computed one precision below the
configuration's float32, in bfloat16.

Inside ``lower_precision()`` every stage of the frozen reference stores its
result in bfloat16 (rounded, then widened back for the next op): each
physics step's state, the posed and projected splats, the compositor's
channels and per-entry gradients, and each Adam update with its moments.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch


def rounded(x, dtype=torch.bfloat16):
    """``x`` with every floating tensor in it (a tensor, a tuple, a named
    tuple, a dict or a dataclass) rounded to ``dtype`` and widened back."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).to(x.dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: rounded(v, dtype) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(rounded(v, dtype) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(rounded(v, dtype) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: rounded(getattr(x, f.name), dtype)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def _wrap(module, name: str, dtype):
    fn = getattr(module, name)

    def lowered(*args, **kwargs):
        return rounded(fn(*args, **kwargs), dtype)

    setattr(module, name, lowered)
    return module, name, fn


@contextmanager
def lower_precision(dtype=torch.bfloat16):
    """Every stage of the frozen reference rounds its results to ``dtype``
    while the context is open."""
    from reference.frozen.ops import composite_vjp, rasterize_cuda
    from reference.frozen.physics import rigid_body
    from reference.frozen.scene import composition
    from reference.frozen.training import trainer

    patched = [
        _wrap(rigid_body, "_step", dtype),
        _wrap(composition, "pose_scene", dtype),
        _wrap(rasterize_cuda, "project_gaussians", dtype),
        _wrap(rasterize_cuda, "composite_tiles_torch", dtype),
        _wrap(composite_vjp, "composite_tiles", dtype),
        _wrap(composite_vjp, "composite_tiles_backward_torch", dtype),
        _wrap(trainer, "project_gaussians", dtype),
        _wrap(trainer.GSTrainer, "_apply_grads", dtype),
    ]
    try:
        yield
    finally:
        for module, name, fn in reversed(patched):
            setattr(module, name, fn)
