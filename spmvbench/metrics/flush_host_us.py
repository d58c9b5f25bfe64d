"""Host time of one flush over the traced stretch: the program's
``serve.flush`` spans (coalesce, the plan's SpMM, the verdict's reduction,
resolving the futures), ``repro_torch.utils.spans.totals()``, over the
stretch's flushes.  Silent where the program has no such span."""


def read(ctx):
    t = ctx.traced
    if not t or not t.get("batches"):
        return None
    try:
        from repro_torch.utils.spans import totals
    except ImportError:
        return None
    fl = totals().get("serve.flush")
    return fl["total_s"] / t["batches"] * 1e6 if fl else None
