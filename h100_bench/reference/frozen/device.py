"""Frozen copy of pegasus_tpu_torch/device.py at commit 7a69f88.

Device selection shared by every constructor and loader of the port.

Entry points take ``device`` and default to the card ("cuda").  Without a
CUDA device that default raises; a caller who wants the plain torch path on
the CPU passes ``device="cpu"`` explicitly.  Nothing falls back.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device for ``device``; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available "
            "(pass device='cpu' to run the plain torch path on the CPU)"
        )
    return dev
