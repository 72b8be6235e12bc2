"""Card-idle time inside the program's ``machine.bulk_apply`` span
outside ``hnsw.link``, per document: F on the host mirrors
(``core/machine.py``: ``WorkingState``, ``_bulk``, ``to_state``)."""
from bench import program_spans


def read(ctx):
    got = program_spans.calls(ctx, "engine.insert_documents", "ingest")
    docs = sum(c.items for c in got or ())
    if not docs:
        return None
    return 1e3 * sum(c.idle.get("machine.bulk_apply", 0.0)
                     for c in got) / docs
