"""Device-to-host reads (``sync`` counts of ``repro_torch.obs``) under
the program's ``engine.retrieve`` span, per call."""
from bench import program_spans


def read(ctx):
    got = program_spans.calls(ctx, "engine.retrieve", "read")
    if not got:
        return None
    return sum(c.counts.get("sync", 0) for c in got) / len(got)
