"""Mean card-idle time of one ``retrieve`` call inside the program's
``engine.copy_out`` span: the ids' and scores' copies back to the host
after the search."""
from bench import program_spans


def read(ctx):
    return program_spans.mean_idle_ms(ctx, "engine.retrieve", "read",
                                      "engine.copy_out")
