"""Quaternion, SH, pose and colour helpers."""
