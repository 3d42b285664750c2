"""Copied verbatim from ``pegasus_tpu/assets/dataset_envs.py``; only the import lines differ.

Import-compatible roster module (reference: src/dataset/dataset_envs.py)."""

from pegasus_tpu_torch.assets.rosters import ENV_CLASSES as _C, CALIBRATION_CLASSES as _K

globals().update(_C)
globals().update(_K)
__all__ = list(_C) + list(_K)
