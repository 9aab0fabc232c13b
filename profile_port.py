#!/usr/bin/env python3
"""Where the flagship roundtrip's time goes on the card.

Profiles one bf16 Encodec_24k_240d roundtrip (batch 8 x 10 s, the main path
of ``chip_smoke.py``) with ``torch.profiler`` and prints the device time of
each kernel name, the sums for the port's kernels (K1 ``rvq_encode``, K2
``lstm2``) and for everything else, and the device's busy and idle shares
of the profiled window. Needs one CUDA device.

    python3 profile_port.py [--top 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke

GROUPS = (  # (group, substrings of the kernel name)
    ("K1 rvq_encode", ("rvq_encode_kernel", "embed_sqnorm_kernel")),
    ("K2 lstm2", ("lstm2_step_kernel",)),
    ("conv (cuDNN)", ("fprop", "dgrad", "conv", "Conv", "winograd", "fft", "implicit")),
    ("gemm (cuBLAS)", ("gemm", "Gemm", "nvjet", "cutlass", "xmma")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, pad, reduce, copy)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device is available", file=sys.stderr)
        return 1
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    run = chip_smoke.phase_main_path("cuda", iters=3)
    model, wav = run["model"], run["input"]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode(model.encode(wav))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name][0] += evt.device_time_total / 1e3
            per_name[evt.name][1] += 1
    busy_ms = sum(t for t, _ in per_name.values())
    if busy_ms == 0.0:
        print("[profile] the profiler recorded no device time: breakdown not measured")
        return 1
    per_group = defaultdict(float)
    for name, (t, _) in per_name.items():
        per_group[group_of(name)] += t
    print(f"[profile] one roundtrip: wall {wall_ms:.3f} ms (host clock, profiler on), "
          f"device busy {busy_ms:.3f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} ({smi})")
    for group, t in sorted(per_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {group:40s} {t:9.3f} ms  {t / busy_ms:6.1%}")
    for name, (t, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"[profile]   {t:9.3f} ms  x{n:<5d} {name[:110]}")
    print(json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "groups_ms": dict(per_group), "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
