"""Mean card-idle time of one ``retrieve`` call inside the program's
``query.plan`` span: ``live_count``'s read of the count and the planner
(``core/shard_wal.py``, ``core/query.py``)."""
from bench import program_spans


def read(ctx):
    return program_spans.mean_idle_ms(ctx, "engine.retrieve", "read",
                                      "query.plan")
