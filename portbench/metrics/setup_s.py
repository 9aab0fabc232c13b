"""Seconds from the process's start to the first timed call: imports, weights, build, warm-up."""


def read(ctx):
    return ctx.setup_s
