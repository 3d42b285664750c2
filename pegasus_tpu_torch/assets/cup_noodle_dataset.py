"""Copied verbatim from ``pegasus_tpu/assets/cup_noodle_dataset.py``; only the import lines differ.

Import-compatible roster module (reference: src/dataset/cup_noodle_dataset.py)."""

from pegasus_tpu_torch.assets.rosters import CUP_NOODLE_CLASSES as _C

globals().update(_C)
__all__ = list(_C)
