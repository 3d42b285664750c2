"""Batched scene generation on one device (the device-mesh paths of the reference are not ported)."""
