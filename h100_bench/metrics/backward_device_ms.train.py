"""Device milliseconds per iteration of the traced segment charged to ``train_step``'s
``train_step/backward`` range (each device event to the range whose host
interval holds the call that queued it)."""

from harness.readout import per_unit, trace
from harness.trace import device_s_in_ranges


def read(run, ctx):
    if not trace(run):
        return None
    split = device_s_in_ranges(run.facts["trace_events"], "train_step/")
    s = split.get("backward", {}).get("total", 0.0)
    return per_unit(run, 1e3 * s, "traced_iterations") if s else None
