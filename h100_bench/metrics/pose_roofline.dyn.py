"""Posing's share of its roofline: the least time of the checked scene's
posing (its moving splats once a frame, ``harness.posing.pose_work``,
counted on the reference's template) over the device time queued inside the
program's ``generate/pose`` ranges within that scene's range; None where the
program opens no such range."""

from harness.posing import pose_trace
from harness.readout import bounds, roofline


def read(run, ctx):
    p = pose_trace(run)
    if not p:
        return None
    name = run.facts["checked"]["scene"]["name"]
    b = bounds(run, ctx, "pose_bound")
    scene = p["scenes"].get(name, {"device_s": 0.0, "launches": 0})
    return roofline(run, b["least_ms"], scene["device_s"],
                    f"posing in {name} ({b['moving_splats']} moving splats x {b['frames']} frames, "
                    f"{b['bytes']} bytes, {b['ops']} operations)", b["bound_by"], scene["launches"])
