"""Mean seconds of ``save2bop`` per scene (``t_finalize``): the writer
pool's PNG backlog drained, the videos closed, the annotations written."""


def read(run, ctx):
    records = run.facts.get("records") or []
    return sum(r["t_finalize"] for r in records) / len(records) if records else None
