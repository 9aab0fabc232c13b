"""Device ms per call of cuDNN's convolution kernels (by name) in the traced block."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.group_ms.get("conv"):
        return None
    return ctx.trace.group_ms["conv"] / len(ctx.trace.calls)
