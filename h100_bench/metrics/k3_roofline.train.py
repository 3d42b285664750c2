"""K3's share of its roofline in training: the least time the frozen
counting gives for the first traced segment's steps over the device time
of the backward kernel's launches in that segment."""

from harness.readout import K3, bounds, range_kernel_s, roofline, trace


def read(run, ctx):
    if not trace(run):
        return None
    b = bounds(run, ctx, "compositor_bounds")
    return roofline(run, b.ms["bwd"], range_kernel_s(run, "segment000", K3), "K3 in segment000",
                    b.bound_by("bwd"), b.launches)
