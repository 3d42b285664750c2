"""Device milliseconds per frame queued inside the program's
``generate/pose`` ranges over the traced window (kernels and copies, each
charged where the call that queued it lies), over the frames written; None
where the program opens no such range."""

from harness.posing import pose_trace
from harness.readout import per_unit


def read(run, ctx):
    p = pose_trace(run)
    return per_unit(run, 1e3 * p["device_s"], "frames") if p and p["device_s"] > 0 else None
