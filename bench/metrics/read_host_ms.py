"""Mean host time of one ``retrieve`` call: its span's length not
covered by device activity (the planner and the engine,
``core/query.py``, ``serve/engine.py``)."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "read"]
    if not spans:
        return None
    return 1e3 * sum(s.seconds - s.busy for s in spans) / len(spans)
