"""Host time of one request's submit over the traced stretch: the self time
of the program's ``serve.submit`` spans (validation and staging; a flush
that a submit triggers is its child and not counted),
``repro_torch.utils.spans.totals()``, over the stretch's requests.  Silent
where the program has no such span."""


def read(ctx):
    t = ctx.traced
    if not t or not t.get("requests"):
        return None
    try:
        from repro_torch.utils.spans import totals
    except ImportError:
        return None
    sub = totals().get("serve.submit")
    return sub["self_s"] / t["requests"] * 1e6 if sub else None
