"""The window's model FLOPs per second over the card's peak for the cell's precision, in %.

The FLOPs are the reference's math at each clip's valid length, counted by
``torch.utils.flop_counter`` on meta tensors; the rate is the untraced
window's (calls completed over its wall time)."""

from portbench.bounds import PEAK_FLOPS


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.window.calls:
        return None
    flops = sum(ctx.model_flops(i) for i in ctx.window.calls)
    return 100.0 * flops / ctx.window.window_s / PEAK_FLOPS[ctx.traffic["dtype"]]
