"""A second traced block with the program's spans on: device time and idle time by program stage.

Only in ``--trace 1`` runs on a card, after the first traced block
(``trace.py``), whose events it leaves as they were: the program's spans are
off there. This block runs ``trace_calls`` more calls through the entry under
``torch.profiler`` (CPU and CUDA activity, events in memory) with the
program's spans switched on (``academicodec_tpu_torch.utils.profiling.spans_on``),
reduces its events once and keeps the result in ``ctx.state["spans"]`` for
every reader. A program without that switch runs no block and reads nothing.

Each device operation (a CUDA event that is not an annotation of the program
or of the benchmark) goes to the innermost program span (``codec.*``,
``kernels.*``, ``train.*``) open on the host when it was launched: at the
start of the CUDA API call (``cuda*`` / ``cu*``) that shares
its correlation id, which also places the kernels launched through ctypes,
under no ``aten`` operator; an operation whose launch is missing from the
trace goes by its own start. Each gap in the union of the device operations
goes to the innermost program span open at its middle, or to
:data:`OUTSIDE`.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from portbench.trace import SPAN_PREFIX, WINDOW

PROGRAM = ("codec.", "kernels.", "train.")  # the program's span names start so
OUTSIDE = "outside the program"


@dataclass
class Stages:
    calls: int
    window_s: float  # the traced block's length
    busy_s: float  # union of device operations
    device_ms: Dict[str, float]  # device ms by innermost program span at launch, or OUTSIDE
    idle_ms: Dict[str, float]  # idle ms by innermost program span at the gap's middle, or OUTSIDE
    unlinked: int  # device operations placed by their own start (no launch in the trace)


def stages(ctx) -> Optional[Stages]:
    """The block's reduction, run once per run (None where nothing was traced)."""
    if "spans" not in ctx.state:
        ctx.state["spans"] = _traced(ctx)
    return ctx.state["spans"]


def per_call(ctx, names) -> Optional[float]:
    """Device ms a call of the block launched in the spans ``names`` (None where it launched none there)."""
    s = stages(ctx)
    if s is None:
        return None
    got = [v for k, v in s.device_ms.items() if k in names]
    return sum(got) / s.calls if got else None


def _traced(ctx) -> Optional[Stages]:
    if ctx.device.type != "cuda" or ctx.trace is None:
        return None
    try:
        from academicodec_tpu_torch.utils.profiling import spans_on
    except ImportError:  # a program without the switch: no spans to read
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    calls = [ctx.trace.calls[-1] + 1 + k for k in range(ctx.traffic["trace_calls"])]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with spans_on(), record_function(WINDOW):
            for i in calls:
                ctx.entry.call(ctx, i)
            torch.cuda.synchronize()
    t1 = time.perf_counter()
    s = reduce(prof.events(), len(calls))
    print(f"[portbench] spans block {t1 - t0:.3f} s, reduced in {time.perf_counter() - t1:.3f} s; "
          f"busy {s.busy_s:.6f} of {s.window_s:.6f} s; {s.unlinked} operations without a launch; "
          f"device ms a call {_by_call(s.device_ms, s.calls)}; idle ms a call {_by_call(s.idle_ms, s.calls)}",
          file=sys.stderr)
    return s


def _by_call(d: Dict[str, float], calls: int) -> Dict[str, float]:
    return {k: round(v / calls, 4) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(PROGRAM + (SPAN_PREFIX,))


def reduce(events, calls: int) -> Stages:
    """The block's events (``torch.profiler``'s ``FunctionEvent``s: ``name``,
    ``device_type``, ``time_range`` in us, ``id`` the correlation id) -> :class:`Stages`."""
    spans: List[Tuple[float, float, str]] = []
    launches: Dict[int, float] = {}
    dev: List[Tuple[float, float, int]] = []
    window = None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not _is_annotation(e):
                dev.append((start, end, e.id))
        elif e.name == WINDOW:
            window = (start, end)
        elif e.name.startswith(PROGRAM):
            spans.append((start, end, e.name))
        elif e.name.startswith("cu"):  # a CUDA API call: a launch, a copy
            launches[e.id] = min(start, launches.get(e.id, start))
    if window is None:
        raise RuntimeError("the traced window's span is missing from the profile")
    w0, w1 = window
    dev = sorted(d for d in dev if w0 <= d[0] < w1)
    spans.sort(key=lambda s: (s[0], -s[1]))  # an outer span before the spans it holds
    starts = [s[0] for s in spans]

    def innermost(t: float) -> str:
        for s0, s1, name in reversed(spans[:bisect.bisect_right(starts, t)]):
            if s1 >= t:  # nested spans: the latest started one still open is the innermost
                return name
        return OUTSIDE

    device_ms, idle_ms = defaultdict(float), defaultdict(float)
    unlinked = 0
    busy, cursor = 0.0, w0
    for start, end, corr in dev:
        launch = launches.get(corr)
        unlinked += launch is None
        device_ms[innermost(start if launch is None else launch)] += (end - start) / 1e3
        if start > cursor:
            idle_ms[innermost((cursor + start) / 2)] += (start - cursor) / 1e3
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        idle_ms[innermost((cursor + w1) / 2)] += (w1 - cursor) / 1e3
    return Stages(calls=calls, window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, device_ms=dict(device_ms),
                  idle_ms=dict(idle_ms), unlinked=unlinked)
