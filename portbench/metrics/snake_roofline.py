"""The Snake epilogues' share of their roofline, in %: the least time of the spans
block's calls' epilogues (``snake_ms`` of the cell's family: f32 operations at the
f32 peak or bytes at the HBM rate, launch by launch from the configuration) over
their device time under ``codec.snake`` in that block (``portbench/spans.py``)."""

from portbench.spans import per_call


def read(ctx):
    least = getattr(ctx.family, "snake_ms", None)
    device_ms = per_call(ctx, ("codec.snake",))
    if least is None or not device_ms:
        return None
    traffic, batches = ctx.traffic, ctx.state["batches"]
    calls = [ctx.trace.calls[-1] + 1 + k for k in range(traffic["trace_calls"])]  # the spans block's
    wavs = [batches[i % len(batches)][0] for i in calls]
    ms = sum(least(ctx.config, w.shape[0], w.shape[1], traffic["dtype"], traffic["decode"]) for w in wavs)
    return 100.0 * ms / len(calls) / device_ms
