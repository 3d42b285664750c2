"""Wall milliseconds per training iteration, host clock, over the window's
segments after the traced one (run with no profiler): what an asset costs
while the host issues the work, and as unsteady as the host's speed."""


def read(run, ctx):
    return run.facts.get("wall_ms_per_iter")
