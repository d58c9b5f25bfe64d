"""Requests completed on the device within the window, over the window.
Host clock."""


def read(ctx):
    r = ctx.result
    return r["completed_in_window"] / r["window_s"]
