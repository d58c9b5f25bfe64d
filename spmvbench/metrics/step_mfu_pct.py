"""The whole call's or solve's share of the card's roofline over the traced
stretch: the least time of its counted work (``counts.bound_seconds`` of
the least bytes and operations of the configured algorithm) over the
stretch's seconds."""
from spmvbench import counts


def read(ctx):
    tr, t = ctx.trace, ctx.traced
    if not tr or not t or not t.get("least_bytes"):
        return None
    least = counts.bound_seconds(t["least_bytes"], t["least_flops"], ctx.bench.compute_dtype())
    return 100.0 * least / tr["window_s"]
