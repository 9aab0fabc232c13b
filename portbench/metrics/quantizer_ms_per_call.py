"""Device ms per call launched inside the program's ``codec.quantize`` and
``codec.dequantize`` spans (the RVQ search K1 and its torch pre- and
post-processing, or GRVQ; the codebook lookups), in the spans block (``portbench/spans.py``)."""

from portbench.spans import per_call


def read(ctx):
    return per_call(ctx, ("codec.quantize", "codec.dequantize"))
