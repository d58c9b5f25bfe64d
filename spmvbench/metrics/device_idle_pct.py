"""Share of the traced stretch in which no operation ran on the card."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
