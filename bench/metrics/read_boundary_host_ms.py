"""Mean card-idle time of one ``retrieve`` call inside the program's
``boundary.admit`` span: the queries' cast and the qboundary launch
(``serve/engine.py``, ``core/boundary.py``)."""
from bench import program_spans


def read(ctx):
    return program_spans.mean_idle_ms(ctx, "engine.retrieve", "read",
                                      "boundary.admit")
