"""The whole ingest step's share of the card's bf16 peak: the model FLOPs
of every document the window's ``insert_documents`` calls embedded (the
engine kind's ``flops_per_doc``, from ``roofline.lm_flops_per_doc``),
over the traced window at 989 TFLOP/s."""
from bench import roofline


def read(ctx):
    per_doc = ctx.system.get("flops_per_doc")
    docs = sum(s.items for s in ctx.spans if s.name == "ingest")
    if not per_doc or not docs:
        return None
    return 100.0 * docs * per_doc / (ctx.trace.window_s
                                     * roofline.PEAK_BF16_FLOPS)
