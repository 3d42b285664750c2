"""Kernel launches per frame made inside the program's ``generate/pose``
ranges over the traced window, over the frames written; None where the
program opens no such range.  Says the window's launches per frame in all
beside it."""

from harness.posing import pose_trace
from harness.readout import per_unit, trace


def read(run, ctx):
    p = pose_trace(run)
    if not p or not p["launches"]:
        return None
    t = trace(run)
    if t:
        run.say(f"launches per frame: {per_unit(run, t['launches'], 'frames'):.4f} in all, "
                f"{per_unit(run, p['launches'], 'frames'):.4f} inside generate/pose")
    return per_unit(run, p["launches"], "frames")
