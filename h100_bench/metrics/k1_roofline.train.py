"""K2''s share of its roofline in training (the K1 kernel launched by
autograd): the least time the frozen counting gives for the first traced
segment's steps over the device time of its launches in that segment."""

from harness.readout import K1, bounds, range_kernel_s, roofline, trace


def read(run, ctx):
    if not trace(run):
        return None
    b = bounds(run, ctx, "compositor_bounds")
    return roofline(run, b.ms["fwd"], range_kernel_s(run, "segment000", K1), "K2' in segment000",
                    b.bound_by("fwd"), b.launches)
