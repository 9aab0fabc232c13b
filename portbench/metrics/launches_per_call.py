"""Device kernels launched per call in the traced block (copies and sets not counted)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.launches / len(ctx.trace.calls)
