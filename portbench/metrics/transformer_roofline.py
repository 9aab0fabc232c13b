"""The transformers' share of their roofline, in %: the least time of the spans
block's calls' transformers (``transformer_ms`` of the cell's family: operations
at the peak of the cell's dtype or bytes at the HBM rate) over their device time
under ``codec.transformer`` in that block (``portbench/spans.py``)."""

from portbench.spans import per_call


def read(ctx):
    least = getattr(ctx.family, "transformer_ms", None)
    device_ms = per_call(ctx, ("codec.transformer",))
    if least is None or not device_ms:
        return None
    traffic, batches = ctx.traffic, ctx.state["batches"]
    calls = [ctx.trace.calls[-1] + 1 + k for k in range(traffic["trace_calls"])]  # the spans block's
    wavs = [batches[i % len(batches)][0] for i in calls]
    ms = sum(least(ctx.config, w.shape[0], w.shape[1], traffic["dtype"], traffic["decode"]) for w in wavs)
    return 100.0 * ms / len(calls) / device_ms
