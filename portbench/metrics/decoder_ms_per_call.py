"""Device ms per call launched inside the program's ``codec.decoder`` span
(SEANet decoder, or the HiFi generator), in the spans block (``portbench/spans.py``)."""

from portbench.spans import per_call


def read(ctx):
    return per_call(ctx, ("codec.decoder",))
