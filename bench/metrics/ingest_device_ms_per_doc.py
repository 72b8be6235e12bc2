"""Device time under ``insert_documents`` per document: the card busy
inside the ingest spans (the HNSW link, ``core/hnsw.py`` -> qhnsw, the
boundary and F's copies)."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "ingest"]
    docs = sum(s.items for s in spans)
    if not docs:
        return None
    return 1e3 * sum(s.busy for s in spans) / docs
