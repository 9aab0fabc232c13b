"""Device ms per call launched inside the program's ``codec.transformer`` spans
(Mimi's two sliding-window transformers), in the spans block (``portbench/spans.py``).
The stage metrics read the rest: ``codec.encoder`` / ``codec.decoder`` leave it out."""

from portbench.spans import per_call


def read(ctx):
    return per_call(ctx, ("codec.transformer",))
