"""Host time a Lanczos solve waits in its steps' reads of alpha and beta
over the traced stretch: the program's ``lanczos.sync`` spans
(``repro_torch.utils.spans.totals()``) over the stretch's completed solves.
Silent where the program has no such span."""


def read(ctx):
    t = ctx.traced
    if not t or not t.get("solves"):
        return None
    try:
        from repro_torch.utils.spans import totals
    except ImportError:
        return None
    sync = totals().get("lanczos.sync")
    return sync["total_s"] / t["solves"] * 1e3 if sync else None
