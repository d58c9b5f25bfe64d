"""The whole window over the Lanczos solves completed (each m steps and
the tridiagonal eigensolve); a solve that broke down is not completed.
Host clock."""


def read(ctx):
    r = ctx.result
    return r["window_s"] / r["solves"] * 1e3 if r["solves"] else None
