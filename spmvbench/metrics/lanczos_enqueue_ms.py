"""Host time a Lanczos solve spends enqueueing its steps' work over the
traced stretch: the program's ``lanczos.step`` spans less their
``lanczos.sync`` children (the read of alpha and beta, which waits for the
card), ``repro_torch.utils.spans.totals()``, over the stretch's completed
solves.  Silent where the program has no such spans."""


def read(ctx):
    t = ctx.traced
    if not t or not t.get("solves"):
        return None
    try:
        from repro_torch.utils.spans import totals
    except ImportError:
        return None
    tot = totals()
    step, sync = tot.get("lanczos.step"), tot.get("lanczos.sync")
    if not step or not sync:
        return None
    return (step["total_s"] - sync["total_s"]) / t["solves"] * 1e3
