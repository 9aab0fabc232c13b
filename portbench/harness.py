"""One run of one cell: set-up, the measured window, the traced block, the check.

Everything that belongs to a cell is found by name from its entry in
``BENCHMARK.json``: the configuration (``configs/<config>.json``), the
traffic mix (``traffic/<traffic>.json``), which names the entry module
(``entries/<entry>.py``), the family of the configuration
(``families/<family>.py``), the limits of the check
(``limits/<workload>.json``) and each metric's reader
(``metrics/<name>.py``, ``read(ctx)`` -> a number or None; a metric named
``<name>.<kind>`` is the same quantity for another kind of cell and takes
the reader ``metrics/<name>.py``).

The window is a closed loop: one client, calls back to back, each ending
with its outputs on the host, until ``seconds`` have passed; the last call
ends the window. A sample of its calls, drawn from the seed, is held
against the reference once the window has closed and the program is freed.
"""

from __future__ import annotations

import importlib
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import trace as tracing

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "academicodec_tpu")  # top-level module names, compared whole


@dataclass
class Window:
    calls: List[int] = field(default_factory=list)  # indices of the completed calls
    call_ms: List[float] = field(default_factory=list)
    audio_s: float = 0.0
    window_s: float = 0.0
    failed: int = 0
    peak_bytes: int = 0


@dataclass
class Context:
    workload: str
    seed: int
    device: torch.device
    benchmark: dict
    config: dict
    traffic: dict
    limits: dict
    family: object
    entry: object
    setup_s: float = 0.0
    state: dict = field(default_factory=dict)
    window: Window = field(default_factory=Window)
    trace: Optional[tracing.Trace] = None
    flops_cache: Dict[int, float] = field(default_factory=dict)

    def model_flops(self, i: int) -> float:
        key = i % self.traffic["batches"]
        if key not in self.flops_cache:
            self.flops_cache[key] = self.entry.model_flops(self, i)
        return self.flops_cache[key]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def make_context(workload: str, seed: int, device, root: Path = ROOT, overrides: Optional[dict] = None) -> Context:
    """The cell's files, found by name. ``overrides`` (tests) update the
    configuration and traffic: ``{"config": {...}, "traffic": {...}}``."""
    benchmark = load_json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    cell = cells[workload]
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits_path = root / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Context(
        workload=workload, seed=int(seed), device=torch.device(device), benchmark=benchmark,
        config=config, traffic=traffic, limits=limits,
        family=importlib.import_module(f"portbench.families.{config['family']}"),
        entry=importlib.import_module(f"portbench.entries.{traffic['entry']}"),
    )


def sync(ctx: Context) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def measure(ctx: Context, seconds: float, rng: random.Random, keep: int) -> list:
    """The window: calls back to back until ``seconds`` have passed. Returns a
    reservoir sample of ``keep`` completed calls ``(index, outputs)`` drawn with ``rng``."""
    win, sample = ctx.window, []
    sync(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            outputs = ctx.entry.call(ctx, i)
        except RuntimeError as exc:  # a call that fails counts as failed and missing
            print(f"[portbench] call {i} failed: {exc!r}", file=sys.stderr)
            win.failed += 1
            outputs = None
        t1 = time.perf_counter()
        if outputs is not None:
            win.calls.append(i)
            win.call_ms.append((t1 - t0) * 1e3)
            win.audio_s += ctx.entry.audio_seconds(ctx, i)
            n = len(win.calls)
            if n <= keep:
                sample.append((i, outputs))
            else:
                j = rng.randrange(n)
                if j < keep:
                    sample[j] = (i, outputs)
        i += 1
        if t1 - start >= seconds:
            break
    win.window_s = time.perf_counter() - start
    if ctx.device.type == "cuda":
        win.peak_bytes = torch.cuda.max_memory_allocated()
    return sample


def reported(ctx: Context, kind: str) -> List[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) this cell reports."""
    return [m for m in ctx.benchmark[kind] if ctx.workload in m.get("workloads", [ctx.workload])]


def read_metrics(ctx: Context, kind: str) -> Dict[str, dict]:
    out = {}
    for m in reported(ctx, kind):
        value = importlib.import_module(f"portbench.metrics.{m['name'].split('.')[0]}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", t_start: Optional[float] = None,
        root: Path = ROOT, overrides: Optional[dict] = None, marks: Optional[list] = None) -> Optional[dict]:
    """One run; returns the result line's object (None where the run may print none).
    ``marks``: ``(part, end time)`` of the set-up's parts before this call."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = list(marks or []) + [("imports", time.perf_counter())]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = make_context(workload, seed, device, root, overrides)
    rng = random.Random(ctx.seed)
    with torch.no_grad():
        ctx.entry.prepare(ctx)
        sync(ctx)
        marks.append(("weights, inputs, program", time.perf_counter()))
        for i in range(ctx.traffic["batches"]):  # warm-up: every input once, nothing compiles later
            ctx.entry.call(ctx, i)
        sync(ctx)
        marks.append(("warm-up", time.perf_counter()))
        setup_peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
        ctx.setup_s = marks[-1][1] - t_start
        print("[portbench] set-up " + ", ".join(f"{name} {t - prev:.3f} s" for (name, t), prev in
                                                zip(marks, [t_start] + [t for _, t in marks])), file=sys.stderr)
        sample = measure(ctx, seconds, rng, ctx.traffic["check_calls"])
        if trace:
            calls = [ctx.window.calls[-1] + 1 + k for k in range(ctx.traffic["trace_calls"])]
            if ctx.device.type == "cuda":
                ctx.trace = tracing.traced_block(lambda i: ctx.entry.call(ctx, i), calls)
        memory_peak = max(setup_peak, ctx.window.peak_bytes)
        metrics = read_metrics(ctx, "per_layer" if trace else "end_to_end")
        ctx.entry.release(ctx)
        checks = check(ctx, sample)
    found = forbidden_modules()
    if found:
        print(f"[portbench] the process holds modules it must not load: {found}", file=sys.stderr)
        return None
    correct = ctx.window.failed == 0 and bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct, "attempted": len(ctx.window.calls) + ctx.window.failed, "failed": ctx.window.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
            "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(memory_peak),
        },
    }
    if ctx.device.type == "cuda":
        result["device"]["power"] = power_limit()
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in ctx.trace.device_ops],
                               "idle_gaps": [list(x) for x in ctx.trace.idle_gaps]}
    result["checks"] = checks
    return result


def check(ctx: Context, sample: list) -> Dict[str, dict]:
    """Each number that the cell's limits file names, the worst over the sampled
    calls, beside its limit (a number no call gave reads None: not correct)."""
    worst: Dict[str, float] = {}
    ref = ctx.entry.reference(ctx)
    for i, outputs in sorted(sample, key=lambda s: s[0]):
        for name, value in ctx.entry.judge(ctx, i, outputs, ref).items():
            worst[name] = max(worst.get(name, float("-inf")), value)
    sync(ctx)
    return {name: {"value": worst.get(name), "limit": limit} for name, limit in ctx.limits.items()}
