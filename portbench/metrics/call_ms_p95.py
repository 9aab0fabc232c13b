"""The 95th percentile of the wall time of every call in the window (host clock), in ms."""

import statistics


def read(ctx):
    ms = ctx.window.call_ms
    return statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) >= 20 else None
