"""Device ms per call launched inside the program's ``codec.snake`` spans (DAC's
fused bias + residual + Snake epilogues), in the spans block (``portbench/spans.py``).
The stage metrics read the rest: ``codec.encoder`` / ``codec.decoder`` leave it out."""

from portbench.spans import per_call


def read(ctx):
    return per_call(ctx, ("codec.snake",))
