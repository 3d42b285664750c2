"""Copied verbatim from ``pegasus_tpu/assets/ycb_objects.py``; only the import lines differ.

Import-compatible roster module (reference: src/dataset/ycb_objects.py).

``from pegasus_tpu_torch.assets.ycb_objects import *`` exposes the 21 YCB-V
classes exactly like the reference's star import (pegasus.py:25).
"""

from pegasus_tpu_torch.assets.rosters import YCB_CLASSES as _C

globals().update(_C)
__all__ = list(_C)
