"""K1, the residual codebook search (csrc/rvq.cu with its codebook pre-pass):
its least time at its calls' shapes over its device time in the traced block, in %."""

from portbench.trace import roofline


def read(ctx):
    return None if ctx.trace is None else roofline(ctx, "k1_rvq")
