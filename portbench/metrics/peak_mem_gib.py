"""``torch.cuda.max_memory_allocated()`` over the window, reset before it, in GiB."""


def read(ctx):
    return ctx.window.peak_bytes / 2**30 if ctx.window.peak_bytes else None
