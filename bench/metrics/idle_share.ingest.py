"""Share of the window with nothing running on the card, in a cell that
ingests."""


def read(ctx):
    if not any(s.name == "ingest" for s in ctx.spans):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
