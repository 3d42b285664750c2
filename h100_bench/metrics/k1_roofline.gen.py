"""K1's share of its roofline in generation: the least time the frozen
counting gives for the checked scene's chunks over the device time of K1's
launches inside that scene's range."""

from harness.readout import K1, bounds, range_kernel_s, roofline, trace


def read(run, ctx):
    if not trace(run):
        return None
    name = run.facts["checked"]["scene"]["name"]
    b = bounds(run, ctx, "k1_bounds")
    return roofline(run, b.ms["fwd"], range_kernel_s(run, name, K1), f"K1 in {name}",
                    b.bound_by("fwd"), b.launches)
