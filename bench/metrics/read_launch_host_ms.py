"""Mean card-idle time of one ``retrieve`` call inside the program's
``query.execute`` span: the search's host preparation and launch
(``core/query.py``, ``kernels/qhnsw/ops.py``, ``kernel.py``)."""
from bench import program_spans


def read(ctx):
    return program_spans.mean_idle_ms(ctx, "engine.retrieve", "read",
                                      "query.execute")
