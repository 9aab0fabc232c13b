"""K4's whole wrapper: the encoder's GroupNorm towers, moments, affines and apply
(csrc/resblock.cu):
its least time at its calls' shapes over its device time in the traced block, in %."""

from portbench.trace import roofline


def read(ctx):
    return None if ctx.trace is None else roofline(ctx, "k4_gn_tower")
