"""Milliseconds per frame the chunk loop was blocked on readback events
(``PEGASUS.last_render_stats["fetch_stall_s"]``, in each stats record)."""

from harness.readout import per_unit


def read(run, ctx):
    records = [r for r in run.facts.get("records") or [] if "fetch_stall_s" in r]
    return per_unit(run, 1e3 * sum(r["fetch_stall_s"] for r in records), "frames") if records else None
