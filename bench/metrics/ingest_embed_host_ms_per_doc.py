"""Card-idle time inside the program's ``lm.embed`` span, per document:
the LM forward's host side (``serve/engine.py`` ``_embed``,
``models/transformer.py``, the MoE's host reads)."""
from bench import program_spans


def read(ctx):
    got = program_spans.calls(ctx, "engine.insert_documents", "ingest")
    docs = sum(c.items for c in got or ())
    if not docs:
        return None
    return 1e3 * sum(c.idle.get("lm.embed", 0.0) for c in got) / docs
