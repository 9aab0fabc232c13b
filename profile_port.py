#!/usr/bin/env python3
"""Where a roundtrip's time goes on the card.

Profiles one bf16 roundtrip at batch 8 x 10 s, the paths of ``chip_smoke.py``:
the flagship Encodec_24k_240d (default) or HiFi-Codec hificodec_24k_320d
(``--preset``). Prints, from ``torch.profiler``, the device time of each
kernel name, the sums for the port's kernels (K1 ``rvq_encode``, K2
``lstm2``, K3 ``resblock_tower``, K4 ``resblock_tower_gn``) and for
everything else, and the device's busy and idle shares of the profiled
window. Needs one CUDA device.

    python3 profile_port.py [--preset hificodec_24k_320d] [--top 20]

``--stream`` runs ``chip_smoke.phase_stream`` (or ``phase_stream_hifi``)
instead (causal models, 8 streams, bf16: 100 ms wav chunks through the
Encodec encoder and decoder sessions, or 10-frame token chunks through the
causal HiFi-Codec generator) and tabulates the ``--chunks`` chunks that the
phase profiles. It adds the device operations per chunk and the host's
busiest operators by self CPU time.

    python3 profile_port.py --stream [--preset hificodec_24k_320d]

``--tower-clocks`` instead builds the kernels with ``-DTOWER_PROFILE`` and
launches K3 once at each flagship stage shape: two blocks of the tensor-core
kernel then print the ``clock64`` counts of their phases (window loads, the
chains, and inside the chains the waits for tap tiles and the epilogues).

    python3 profile_port.py --tower-clocks
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

import torch

import chip_smoke

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("K1 rvq_encode", ("rvq_encode_kernel", "embed_sqnorm_kernel", "embed_tiles_kernel")),
    ("K2 lstm2", ("lstm2_kernel",)),
    ("K4 resblock_tower_gn", ("gn_tower_kernel", "gn_tower_fma_kernel", "moments_reduce_kernel",
                              "gn_affine_kernel", "gn_apply_kernel")),
    ("K3 resblock_tower", ("tower_kernel", "tower_fma_kernel")),
    ("conv (cuDNN)", ("fprop", "dgrad", "conv", "Conv", "winograd", "fft", "implicit")),
    ("gemm (cuBLAS)", ("gemm", "Gemm", "nvjet", "cutlass", "xmma")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, pad, reduce, copy)"


def tower_clocks() -> None:
    """One K3 launch at the s2 and at the s3 shape from a ``-DTOWER_PROFILE`` build."""
    ops = chip_smoke.resblock_ops
    for tag, C, T in (("s2", 64, 120000), ("s3", 32, 240000)):
        weights, biases = chip_smoke._tower_weights(C, chip_smoke.RB1_KS, chip_smoke.RB1_DS, "cuda",
                                                    torch.bfloat16, seed=C)
        packed = ops.pack_tower(weights, biases, kernel_sizes=chip_smoke.RB1_KS,
                                dilation_sizes=chip_smoke.RB1_DS)
        x = chip_smoke._randn((8, C, T), "cuda", torch.bfloat16, seed=T)
        print(f"[clocks] {tag} [8,{C},{T}] {chip_smoke._geometry(packed, gn=False)}", flush=True)
        ops.resblock_tower(x, packed)
        torch.cuda.synchronize()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default=chip_smoke.FLAGSHIP,
                        choices=(chip_smoke.FLAGSHIP, chip_smoke.HIFI))
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--stream", action="store_true", help="profile streaming chunks instead")
    parser.add_argument("--chunks", type=int, default=10, help="chunks in the --stream window")
    parser.add_argument("--tower-clocks", action="store_true",
                        help="print clock64 phase counts of K3 blocks from a -DTOWER_PROFILE build")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device is available", file=sys.stderr)
        return 1
    smi = chip_smoke.phase_device()
    if args.tower_clocks:
        chip_smoke.kernel_build.NVCC_FLAGS.append("-DTOWER_PROFILE")
        chip_smoke.phase_build()
        tower_clocks()
        return 0
    chip_smoke.phase_build()
    if args.stream:
        # the window of chip_smoke's streaming phase, profiled there
        phase = chip_smoke.phase_stream_hifi if args.preset == chip_smoke.HIFI else chip_smoke.phase_stream
        run = phase("cuda", profile_chunks=args.chunks)
        prof, wall_ms = run["profile"], run["profiled_wall_ms"]
        window = f"{args.chunks} stream chunks"
    else:
        if args.preset == chip_smoke.HIFI:
            run = chip_smoke.phase_hificodec("cuda", iters=3)
        else:
            run = chip_smoke.phase_main_path("cuda", iters=3)
        model, wav = run["model"], run["input"]
        wall_ms, _, _, prof = chip_smoke.device_busy(lambda: model.decode(model.encode(wav)))
        window = "one roundtrip"

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
    print(f"[profile] {args.preset} {window}: wall {wall_ms:.3f} ms (host clock, profiler on), "
          f"device busy {busy_ms:.3f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} ({smi})")
    for group, t in sorted(per_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {group:40s} {t:9.3f} ms  {t / busy_ms:6.1%}")
    for name, (t, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"[profile]   {t:9.3f} ms  x{n:<5d} {name[:110]}")
    if args.stream:
        print("[profile] host operators by self CPU time:")
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[: args.top]
        for e in host:
            print(f"[profile]   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count / args.chunks:<7.1f}/chunk {e.key[:90]}")
    print(json.dumps({
        "preset": args.preset, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "groups_ms": dict(per_group), "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
