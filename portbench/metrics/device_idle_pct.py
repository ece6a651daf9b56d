"""The share of the traced window in which no operation ran on the card:
100 x (1 - the union of the device events' intervals / the window)."""


def read(ctx):
    if ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
