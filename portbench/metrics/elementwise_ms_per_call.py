"""Device ms per call of every kernel outside the named groups (the port's kernels,
cuDNN, cuBLAS, copies): elementwise, pads, reductions, layout copies."""

from portbench.bounds import OTHER


def read(ctx):
    if ctx.trace is None or not ctx.trace.group_ms.get(OTHER):
        return None
    return ctx.trace.group_ms[OTHER] / len(ctx.trace.calls)
