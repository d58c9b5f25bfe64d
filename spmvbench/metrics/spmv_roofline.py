"""Least bytes of the SpMVs of the traced stretch (``counts.spmv_bytes``:
the values the operator cannot avoid once per pass over the matrix, each x
read and each y written once) at 3.35 TB/s, over the profiler's time in
the port's SpMV kernels.  Silent where no such kernel ran."""
from spmvbench import counts


def read(ctx):
    tr, t = ctx.trace, ctx.traced
    if not tr or not t or not t.get("spmv_passes"):
        return None
    spmv = sum(s for name, s in tr["ops_s"].items() if counts.is_spmv_kernel(name))
    if not spmv:
        return None
    b = ctx.bench
    nbytes = t["spmv_passes"] * b.value_bytes() + (
        b.spmv_bytes(t["spmv_columns"]) - b.value_bytes())
    return 100.0 * nbytes / counts.H100_BYTES_PER_S / spmv
