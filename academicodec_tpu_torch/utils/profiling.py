"""Profiling: program spans and counters in one registry, a ``torch.profiler``
trace, and parameter counts.

The port's counterpart of academicodec_tpu/utils/profiling.py.

**Spans and counters.** ``span(name)`` (a context manager and a decorator)
marks one stage of the program: ``codec.encode`` / ``codec.decode`` (one
public call), ``codec.upload``, ``codec.encoder``, ``codec.quantize``,
``codec.dequantize``, ``codec.decoder``, ``codec.load``, ``kernels.load``,
``train.step``, ``train.g_phase``, ``train.d_phase``. Every span always adds
one count and its host seconds (``time.perf_counter_ns``) to the process's
registry; ``count(name, n)`` adds to a plain counter there (``k1.launches``
... ``k4.launches``, ``p1.launches``, ``p2.launches``, ``int8.gemms``,
``kernels.builds``; ``towers.cl_convs`` and ``towers.layout_copies``, the
convs run on channels-last ``[B, C, 1, T]`` operands and the layout changes
around them, ``nn/conv.py``, ``nn/hifigan.py``). ``totals()`` returns a snapshot, ``reset()`` clears it (or some names).

Spans reach the profiler's timeline only when switched on, inside the
:func:`spans_on` block (``trace`` switches them on for its block): each span then also opens ``torch.profiler.record_function(name)``,
so that under a CUDA-activity profiler it sits on the clock of the kernels it
launches, nested in the span that holds it (its parent) and, through the
root span of its call (``codec.encode``, ``codec.decode``, ``train.step``),
in that call. Switched off, a span costs two clock reads and one update of
the registry; spans mark stages, never single modules or launches.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


class Total(NamedTuple):
    count: int
    seconds: float  # host seconds inside the span (0 for a plain counter)


class Registry:
    """Counts and host seconds by name for the whole process, and whether spans
    go on the profiler's timeline."""

    def __init__(self):
        self.spans_on = False
        self._lock = threading.Lock()
        self._totals: Dict[str, List] = {}  # name -> [count, nanoseconds]

    def add(self, name: str, count: int, ns: int = 0) -> None:
        self._lock.acquire()  # half the cost of ``with``, on the path of every span and launch
        try:
            t = self._totals.get(name)
            if t is None:
                self._totals[name] = [count, ns]
            else:
                t[0] += count
                t[1] += ns
        finally:
            self._lock.release()

    def get(self, name: str) -> Total:
        with self._lock:
            c, ns = self._totals.get(name, (0, 0))
        return Total(c, ns / 1e9)

    def snapshot(self) -> Dict[str, Total]:
        with self._lock:
            return {name: Total(c, ns / 1e9) for name, (c, ns) in self._totals.items()}

    def clear(self, names=()) -> None:
        with self._lock:
            if names:
                for name in names:
                    self._totals.pop(name, None)
            else:
                self._totals.clear()


REGISTRY = Registry()


class span:
    """One stage of the program, as a ``with`` block or a function decorator
    (module docstring)."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self) -> "span":
        if REGISTRY.spans_on:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        REGISTRY.add(self.name, 1, time.perf_counter_ns() - self._t0)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    REGISTRY.add(name, n)


def totals() -> Dict[str, Total]:
    """Every span's and counter's count and host seconds so far in this process."""
    return REGISTRY.snapshot()


def total(name: str) -> Total:
    """The count and host seconds of one span or counter so far (zeros before its first)."""
    return REGISTRY.get(name)


def reset(*names: str) -> None:
    """Clear the totals of the spans and counters ``names``, or of every one."""
    REGISTRY.clear(names)


@contextlib.contextmanager
def spans_on() -> Iterator[None]:
    """Spans on the profiler's timeline inside the block; as they were after it."""
    saved = REGISTRY.spans_on
    REGISTRY.spans_on = True
    try:
        yield
    finally:
        REGISTRY.spans_on = saved


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the enclosed block, program spans on, into ``logdir/trace.json``
    (nothing when ``logdir`` is None). Open it in Perfetto."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with spans_on(), torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def param_count(module: torch.nn.Module) -> int:
    """Total parameter count (reference getModelSize, main_launch.py:23-36)."""
    return sum(p.numel() for p in module.parameters())
