"""Mean card-idle time of one ``retrieve`` call inside the program's
``engine.retrieve`` span outside its children: the flush and its read of
the cursor, the replica choice, the plan's bookkeeping
(``serve/engine.py``)."""
from bench import program_spans


def read(ctx):
    return program_spans.mean_idle_ms(ctx, "engine.retrieve", "read",
                                      "engine.retrieve")
