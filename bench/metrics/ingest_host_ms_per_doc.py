"""Host time of ``insert_documents`` per document: each ingest span's
length not covered by device activity (the engine and F on the host,
``serve/engine.py``, ``core/machine.py``, ``core/boundary.py``)."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "ingest"]
    docs = sum(s.items for s in spans)
    if not docs:
        return None
    return 1e3 * sum(s.seconds - s.busy for s in spans) / docs
