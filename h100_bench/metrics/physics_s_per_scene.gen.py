"""Mean seconds of a scene's drop (``t_physics`` of ``run_generation``'s
stats records)."""


def read(run, ctx):
    records = run.facts.get("records") or []
    return sum(r["t_physics"] for r in records) / len(records) if records else None
