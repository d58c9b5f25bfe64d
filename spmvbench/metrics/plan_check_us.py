"""Host time of the operand checks per plan call over the traced stretch:
the self time of the program's ``plan.operand`` spans (``SpMVPlan.spmv``:
operand, shape, fault point) and ``kernel.check`` spans (the CUDA
wrappers' checks before a launch), ``repro_torch.utils.spans.totals()``,
over the stretch's calls.  Silent where the program has no such spans."""


def read(ctx):
    t = ctx.traced
    if not t or not t.get("units"):
        return None
    try:
        from repro_torch.utils.spans import totals
    except ImportError:
        return None
    tot = totals()
    parts = [tot[n]["self_s"] for n in ("plan.operand", "kernel.check") if n in tot]
    return sum(parts) / t["units"] * 1e6 if parts else None
