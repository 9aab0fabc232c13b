"""Device idle ms per call while the host is inside any of the program's spans,
in the spans block (``portbench/spans.py``): the idle the program causes."""

from portbench.spans import OUTSIDE, stages


def read(ctx):
    s = stages(ctx)
    if s is None or not any(k != OUTSIDE for k in s.device_ms):  # no program span in the block
        return None
    return sum(v for k, v in s.idle_ms.items() if k != OUTSIDE) / s.calls
