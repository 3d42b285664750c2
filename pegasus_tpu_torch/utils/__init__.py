"""Quaternion, SH, pose and colour helpers."""

from pegasus_tpu_torch.utils import quaternion, pose, sh, colors
