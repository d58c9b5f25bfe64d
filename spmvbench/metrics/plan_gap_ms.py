"""Host time around the kernels per plan call: the traced stretch over its
calls, less the device time of the SpMV kernels per call."""
from spmvbench.counts import is_spmv_kernel


def read(ctx):
    tr, t = ctx.trace, ctx.traced
    if not tr or not t or not t.get("units"):
        return None
    spmv = sum(s for name, s in tr["ops_s"].items() if is_spmv_kernel(name))
    return (tr["window_s"] - spmv) / t["units"] * 1e3 if spmv else None
