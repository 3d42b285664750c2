"""Milliseconds of the chunk loop per frame: ``t_render`` of the stats
records (render, readback, unpack and hand-off to the writer pool) over
the frames."""

from harness.readout import per_unit


def read(run, ctx):
    records = run.facts.get("records") or []
    return per_unit(run, 1e3 * sum(r["t_render"] for r in records), "frames") if records else None
