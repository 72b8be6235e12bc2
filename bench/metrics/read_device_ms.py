"""Mean device time under one ``retrieve`` call (the search,
``core/query.py`` -> qhnsw_search, and the boundary)."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "read"]
    if not spans:
        return None
    return 1e3 * sum(s.busy for s in spans) / len(spans)
