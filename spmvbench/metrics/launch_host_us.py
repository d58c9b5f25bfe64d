"""Host time of one kernel launch over the traced stretch: the program's
``kernel.launch`` spans (``repro_torch.kernels.cuda_build.launch``: entry
point, device, stream, the ctypes call, its error code, the launch count),
their total over their count (``repro_torch.utils.spans.totals()``).
Silent where the program has no such span."""


def read(ctx):
    try:
        from repro_torch.utils.spans import totals
    except ImportError:
        return None
    tot = totals().get("kernel.launch")
    return tot["total_s"] / tot["n"] * 1e6 if tot and tot["n"] else None
