#!/usr/bin/env python3
"""Where a roundtrip's time goes on the card.

Profiles one bf16 roundtrip at batch 8 x 10 s, the paths of ``chip_smoke.py``:
the flagship Encodec_24k_240d (default) or HiFi-Codec hificodec_24k_320d
(``--preset``). Prints, from ``torch.profiler``, the device time of each
kernel name, the sums for the port's kernels (K1 ``rvq_encode``, K2
``lstm2``, K3 ``resblock_tower``, K4 ``resblock_tower_gn``) and for
everything else, and the device's busy and idle shares of the profiled
window. Needs one CUDA device.

    python3 profile_port.py [--preset hificodec_24k_320d [--fused-pre]] [--top 20]

``--fused-pre`` profiles the HiFi-Codec roundtrip with
``generator.fused_pre = True``: each fused stage's lrelu and upsampling
conv-transpose run inside K3, so their cuDNN and elementwise passes leave
the table.

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

``--train-flops`` counts, with ``torch.utils.flop_counter`` on the CPU (no
card needed), the forward FLOPs of each module of the Encodec_24k_240d
trainer (``chip_smoke.TRAIN_RECIPE``) for one 1 s item: the SEANet encoder
and decoder, the three discriminator families and the mel loss. With
``--preset hificodec_24k_320d`` it counts the HiFi-Codec trainer's modules
(``chip_smoke.phase_train_hifi``'s recipe and discriminators) for one
16000-sample item, and the token LM's at ``cli/train_lm.py``'s width for
one 1 s item of Encodec_24k_240d's 12 streams, on meta tensors (shapes
only, nothing computed).

    python3 profile_port.py --train-flops [--preset hificodec_24k_320d]
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


def train_flops() -> dict:
    """Forward GFLOP of each trainer module for one 1 s item at the recipe's widths."""
    from torch.utils.flop_counter import FlopCounterMode

    from academicodec_tpu_torch.losses.mel import mel_reconstruction_loss
    from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer

    cfg = EncodecTrainConfig(**chip_smoke.TRAIN_RECIPE)
    state = EncodecTrainer(cfg, device="cpu").init_state(0)
    x = chip_smoke.seeded_wav(1, cfg.sr, "cpu")
    model, discs = state.generator, state.discriminators
    out = {}

    def count(name, fn):
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            result = fn()
        out[name] = fc.get_total_flops() / 1e9
        return result

    e = count("encoder", lambda: model.encoder(x[:, None]))
    y = count("decoder", lambda: model.decoder(e))[:, 0]
    for family in ("stft_disc", "mpd", "msd"):
        count(family, lambda: getattr(discs, family)(x))
    count("mel_loss", lambda: mel_reconstruction_loss(x, y, cfg.sr, scale_powers=cfg.mel_scale_powers))
    return out


def hifi_train_flops() -> dict:
    """Forward GFLOP of each HiFi-Codec trainer module for one 16000-sample item,
    and of the token LM for one 1 s item (100 frames x 12 streams), counted on
    meta tensors (the modules are built on the CPU and moved there)."""
    from torch.utils.flop_counter import FlopCounterMode

    from academicodec_tpu_torch.losses.mel import hifigan_mel_losses
    from academicodec_tpu_torch.models.hificodec import VQVAE
    from academicodec_tpu_torch.models.lm import RVQTokenLM
    from academicodec_tpu_torch.train.hificodec import Discriminators

    cfg, _ = chip_smoke.hifi_recipe()
    model = VQVAE(cfg, device="cpu").to("meta")
    discs = Discriminators(**chip_smoke.HIFI_TRAIN_DISCS).to("meta")
    lm = RVQTokenLM(n_q=12, bins=1024, **chip_smoke.LM_WIDTH, device="cpu").to("meta")
    x = torch.zeros((1, cfg.segment_size), device="meta")
    out = {}

    def count(name, fn):
        with FlopCounterMode(display=False) as fc:
            result = fn()
        out[name] = fc.get_total_flops() / 1e9
        return result

    c = count("encoder", lambda: model.encoder(x[:, None]))  # parameters on meta need grad: the unfused path
    q = count("quantizer", lambda: model.quantizer(c.transpose(1, 2))[0])
    y = count("generator", lambda: model.generator(q.transpose(1, 2)))[:, 0]
    for family in ("mpd", "msd", "mstftd"):
        count(family, lambda: getattr(discs, family)(x))
    mel = dict(n_fft=cfg.n_fft, num_mels=cfg.num_mels, sampling_rate=cfg.sampling_rate, hop_size=cfg.hop_size,
               win_size=cfg.win_size, fmin=cfg.fmin, fmax_for_loss=cfg.fmax_for_loss)
    count("mel_loss", lambda: hifigan_mel_losses(x, y, None, **mel))
    count("lm_1s", lambda: lm(torch.zeros((1, 100, 12), dtype=torch.long, device="meta")))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default=chip_smoke.FLAGSHIP,
                        choices=(chip_smoke.FLAGSHIP, chip_smoke.HIFI))
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--stream", action="store_true", help="profile streaming chunks instead")
    parser.add_argument("--chunks", type=int, default=10, help="chunks in the --stream window")
    parser.add_argument("--tower-clocks", action="store_true",
                        help="print clock64 phase counts of K3 blocks from a -DTOWER_PROFILE build")
    parser.add_argument("--fused-pre", action="store_true",
                        help="HiFi-Codec: fuse each narrow stage's upsampling convT into K3 (generator.fused_pre)")
    parser.add_argument("--train-flops", action="store_true",
                        help="count the Encodec (or with --preset hificodec_24k_320d the HiFi-Codec and LM) "
                             "trainer's forward FLOPs per item (on the CPU)")
    args = parser.parse_args(argv)
    if args.train_flops and args.preset == chip_smoke.HIFI:
        print(f"[train_flops] HiFi-Codec forward GFLOP per 16000-sample item, LM per 1 s item: "
              f"{json.dumps(hifi_train_flops())}")
        return 0
    if args.train_flops:
        print(f"[train_flops] forward GFLOP per 1 s item: {json.dumps(train_flops())}")
        return 0
    if args.fused_pre and (args.preset != chip_smoke.HIFI or args.stream):
        parser.error("--fused-pre applies to the HiFi-Codec roundtrip (--preset hificodec_24k_320d, no --stream)")
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
        window = "one roundtrip"
        if args.fused_pre:
            model.generator.fused_pre = True
            model.decode(model.encode(wav))  # packs the stages with their prologue
            window += " with generator.fused_pre"
        wall_ms, _, _, prof = chip_smoke.device_busy(lambda: model.decode(model.encode(wav)))

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
        "preset": args.preset, "fused_pre": args.fused_pre, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "groups_ms": dict(per_group), "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
