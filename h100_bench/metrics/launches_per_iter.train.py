"""Kernel launches per training iteration: the host's launch calls in the
traced segment over its iterations."""

from harness.readout import per_unit, trace


def read(run, ctx):
    t = trace(run)
    return per_unit(run, t["launches"], "traced_iterations") if t and t["launches"] else None
