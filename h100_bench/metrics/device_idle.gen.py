"""Per cent of the traced window in which no operation ran on the device."""

from harness.readout import trace


def read(run, ctx):
    t = trace(run)
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
