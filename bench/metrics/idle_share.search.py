"""Share of the window with nothing running on the card, in a cell that
only reads."""


def read(ctx):
    names = {s.name for s in ctx.spans}
    if names != {"read"}:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
