"""K2, the 2-layer LSTM recurrence (csrc/lstm2.cu):
its least time at its calls' shapes over its device time in the traced block, in %."""

from portbench.trace import roofline


def read(ctx):
    return None if ctx.trace is None else roofline(ctx, "k2_lstm2")
