"""The paper's measure: 2 nnz of the configuration's CSR for every SpMV the
closed loop completed, over the whole window.  Host clock."""


def read(ctx):
    r = ctx.result
    return 2.0 * ctx.bench.nnz * r["calls"] / r["window_s"] / 1e9
