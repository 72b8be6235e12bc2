"""Bytes read back from the card (``sync_bytes`` of ``repro_torch.obs``)
under the program's ``engine.insert_documents`` span, in KiB per
document: mostly F's host mirrors of the arena."""
from bench import program_spans


def read(ctx):
    got = program_spans.calls(ctx, "engine.insert_documents", "ingest")
    docs = sum(c.items for c in got or ())
    if not docs:
        return None
    return sum(c.counts.get("sync_bytes", 0) for c in got) / 1024 / docs
