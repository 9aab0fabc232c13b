"""A traced block of calls: device time by kernel group, busy and idle time, launches.

The block runs under ``torch.profiler`` (CPU and CUDA activity), its events
kept in memory. Device operations are the CUDA events that are not the
benchmark's own annotations; their union is the busy time, and each gap
in it is named by what the host was doing at its middle: the benchmark's
span of the call (``portbench.encode``, ...) and the innermost ``aten``
operator running then.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.bounds import group_of

WINDOW = "portbench.traced_window"
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    calls: List[int]  # the call indices traced
    window_s: float  # the traced block's length
    busy_s: float  # union of device operations
    group_ms: Dict[str, float]  # device ms by kernel group (portbench.bounds.GROUPS)
    launches: int  # device kernels (copies and sets not counted)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)  # the 10 longest by name, seconds
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)  # idle seconds by host activity, top 10


def traced_block(call: Callable[[int], object], calls: List[int]) -> Trace:
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in calls:
                call(i)
            torch.cuda.synchronize()
    return summarize(prof.events(), calls)


def summarize(events, calls: List[int]) -> Trace:
    cpu, dev = [], []
    window: Optional[Tuple[float, float]] = None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):
                dev.append((start, end, e.name))
        elif e.name == WINDOW:
            window = (start, end)
        else:
            cpu.append((start, end, e.name))
    if window is None:
        raise RuntimeError("the traced window's span is missing from the profile")
    w0, w1 = window
    dev = sorted(d for d in dev if d[0] >= w0 and d[0] < w1)
    by_name, by_group = defaultdict(float), defaultdict(float)
    launches = 0
    for start, end, name in dev:
        by_name[name] += (end - start) / 1e6
        group = group_of(name)
        by_group[group] += (end - start) / 1e3
        launches += group != "memcpy"
    busy, gaps = 0.0, []
    cursor = w0
    for start, end, _ in dev:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    idle = defaultdict(float)
    namer = _HostNamer(cpu)
    for a, b in gaps:
        idle[namer.at((a + b) / 2)] += (b - a) / 1e6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return Trace(calls=list(calls), window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, group_ms=dict(by_group),
                 launches=launches, device_ops=top(by_name), idle_gaps=top(idle))


class _HostNamer:
    """The benchmark span and the innermost ``aten`` operator running on the host at a time."""

    def __init__(self, cpu: List[Tuple[float, float, str]]):
        self.spans = sorted(c for c in cpu if c[2].startswith(SPAN_PREFIX))
        self.ops = sorted(c for c in cpu if c[2].startswith("aten::"))
        self.op_starts = [c[0] for c in self.ops]

    def at(self, t: float) -> str:
        span = next((s[2] for s in self.spans if s[0] <= t <= s[1]), "between calls")
        j = bisect.bisect_right(self.op_starts, t)
        op = next((o[2] for o in reversed(self.ops[max(0, j - 64):j]) if o[1] >= t), None)
        return span if op is None else f"{span} / {op}"


def roofline(ctx, group: str) -> Optional[float]:
    """A kernel group's share of its roofline in the traced block, in %: the least
    time of its calls over its device time. None where the block ran none."""
    trace = ctx.trace
    device_ms = trace.group_ms.get(group, 0.0)
    least = sum(sum(ctx.entry.kernel_bounds(ctx, i).get(group, [])) for i in trace.calls)
    if device_ms <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / device_ms
