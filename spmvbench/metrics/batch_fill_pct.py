"""Mean real width of the server's flushes over its policy width, over the
whole window and its drain (``BatchingSpMVServer.stats()``)."""


def read(ctx):
    r = ctx.result
    if not r.get("batches"):
        return None
    return 100.0 * r["columns"] / r["batches"] / r["width"]
