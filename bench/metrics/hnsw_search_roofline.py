"""Share of the roofline of the checked reads: the work the reference's
plain beams needed to answer them (``roofline``), over the device time
under those ``retrieve`` calls' spans."""
from bench import roofline


def read(ctx):
    checked = [w for w in ctx.work.get("hnsw_search", [])
               if w.get("span") is not None]
    if not checked:
        return None
    bound = sum(roofline.hnsw_bound_s(w["rows"], w["dists"],
                                      ctx.system["d_model"],
                                      ctx.system["row_bytes"])
                for w in checked)
    return roofline.share(bound, sum(ctx.spans[w["span"]].busy
                                     for w in checked))
