"""Set-up seconds: process start to the first timed call (imports, kernel
libraries or their build, matrix, plan, warm-up).  Host clock."""


def read(ctx):
    return ctx.setup_s
