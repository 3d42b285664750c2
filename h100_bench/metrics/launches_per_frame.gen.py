"""Kernel launches per frame: the host's launch calls in the traced window
over the frames written."""

from harness.readout import per_unit, trace


def read(run, ctx):
    t = trace(run)
    return per_unit(run, t["launches"], "frames") if t and t["launches"] else None
