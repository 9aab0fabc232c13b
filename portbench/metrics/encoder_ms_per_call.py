"""Device ms per call launched inside the program's ``codec.encoder`` span
(SEANet encoder with its SLSTM, or the HiFi encoder), in the spans block (``portbench/spans.py``)."""

from portbench.spans import per_call


def read(ctx):
    return per_call(ctx, ("codec.encoder",))
