"""The share of the traced block in which no operation ran on the device, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s / ctx.trace.window_s)
