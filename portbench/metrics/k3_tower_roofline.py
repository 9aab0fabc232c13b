"""K3, the generator's resblock towers (csrc/resblock.cu tower kernels):
its least time at its calls' shapes over its device time in the traced block, in %."""

from portbench.trace import roofline


def read(ctx):
    return None if ctx.trace is None else roofline(ctx, "k3_tower")
