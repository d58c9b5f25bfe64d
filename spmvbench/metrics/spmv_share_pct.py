"""Share of the traced stretch's device busy time spent in the port's SpMV
kernels (``counts.SPMV_KERNELS``), from the profiler's kernel names."""
from spmvbench.counts import is_spmv_kernel


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["busy_s"]:
        return None
    spmv = sum(s for name, s in tr["ops_s"].items() if is_spmv_kernel(name))
    return 100.0 * spmv / tr["busy_s"] if spmv else None
