"""Profiling hooks: a ``torch.profiler`` trace, a step timer and parameter counts.

The port's counterpart of academicodec_tpu/utils/profiling.py. ``trace(logdir)``
records the enclosed steps on the host and, when a card is present, on the
device, and writes a Chrome trace to ``logdir`` (open it in Perfetto);
``StepTimer`` gives steady-state seconds per step after a warm-up.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the enclosed block into ``logdir/trace.json`` (nothing when ``logdir`` is None)."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling seconds per step, skipping warm-up steps. Call :meth:`tick` after
    the step's results are on the host (a read of its metrics synchronises)."""

    def __init__(self, warmup: int = 2, window: int = 50):
        self.warmup, self.window = warmup, window
        self._times: list = []
        self._count = 0
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        self._count += 1
        if self._count > self.warmup and self._last is not None:
            self._times = (self._times + [now - self._last])[-self.window :]
        self._last = now
        return float(np.mean(self._times)) if self._times else None

    @property
    def steps_per_sec(self) -> Optional[float]:
        return 1.0 / float(np.mean(self._times)) if self._times else None


def param_count(module: torch.nn.Module) -> int:
    """Total parameter count (reference getModelSize, main_launch.py:23-36)."""
    return sum(p.numel() for p in module.parameters())
