"""Token-LM training CLI of the port (the JAX CLI's flags plus ``--device``).

A frozen codec tokenizes wav crops on the fly and ``RVQTokenLM`` is trained
teacher-forced on the token streams (``train/lm.py``); the checkpoint
directory (``lm_config.json`` + ``lm_<step>.pt``, ``models/lm.save_lm``, with
the family and the frames of a training crop) is what ``cli/compress.py
--lm`` (family ``encodec``) and ``cli/extract_tokens.py --lm`` (family
``hificodec``) take.

    python -m academicodec_tpu_torch.cli.train_lm --train_data_path /data/train \\
        --resume_path best_x.pth --sr 24000 --ratios 6 5 4 2 --target_bandwidths 1 2 4 8 12 \\
        --target_bw 12 --steps 20000 --path ckpts/lm_24k --device cuda

The codec comes through ``api.load_codec``: a reference ``.pth`` or a
``cli/train_encodec.py`` state with ``--family encodec`` (its flags give the
SoundStream; ``SoundStream.encode`` at ``--target_bw``, K1 and K2 on the
card), a reference ``g_*`` or a ``cli/train_hificodec.py`` state with
``--family hificodec --hifi_config`` (``VQVAE.encode``, K4 on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.data.dataset import WavCropDataset, batch_iterator
from academicodec_tpu_torch.models.lm import save_lm
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.train.lm import LMTrainConfig, LMTrainer
from academicodec_tpu_torch.utils.logging import Logger


def get_args(argv=None):
    p = argparse.ArgumentParser("train_lm")
    p.add_argument("--train_data_path", type=str, required=True)
    p.add_argument("--resume_path", type=str, required=True, help="codec checkpoint")
    p.add_argument("--family", choices=("encodec", "hificodec"), default="encodec",
                   help="token source: 'encodec' models the SoundStream RVQ streams at --target_bw; "
                        "'hificodec' the GRVQ 4-stream tokens; requires --hifi_config")
    p.add_argument("--hifi_config", type=str, default=None, help="HiFi-Codec model config JSON")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--ratios", type=int, nargs="+", default=[8, 5, 4, 2])
    p.add_argument("--target_bandwidths", type=float, nargs="+", default=[1, 1.5, 2, 4, 6, 12])
    p.add_argument("--n_filters", type=int, default=32)
    p.add_argument("--dimension", type=int, default=512)
    p.add_argument("--bins", type=int, default=1024)
    p.add_argument("--target_bw", type=float, default=12, help="bandwidth whose token streams the LM models")
    p.add_argument("--lm_dim", type=int, default=200)
    p.add_argument("--lm_heads", type=int, default=8)
    p.add_argument("--lm_layers", type=int, default=5)
    p.add_argument("--past_context", type=int, default=1000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--cosine_decay", action="store_true",
                   help="warmup+cosine lr decay over --steps (constant lr otherwise)")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--segment_seconds", type=float, default=1.0,
                   help="training crop length; streams longer than it are out of distribution for the LM")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--checkpoint_interval", type=int, default=1000)
    p.add_argument("--path", type=str, required=True, help="LM checkpoint dir")
    p.add_argument("--device", type=str, default="cuda", help="torch device; the card unless cpu is asked for")
    args = p.parse_args(argv)
    if args.family == "hificodec" and not args.hifi_config:
        p.error("--family hificodec requires --hifi_config")
    return args


def codec_encoder(args):
    """``(encode, sample rate, bins)``: ``encode(wav [B, T]) -> codes [B, frames, n_q]``
    int64 on the device, by the frozen codec of ``args``."""
    if args.family == "hificodec":
        with open(args.hifi_config) as fh:
            hcfg = HiFiCodecConfig.from_json(json.load(fh))
        codec = load_codec("hificodec_24k_320d", args.resume_path, device=args.device,
                           **dataclasses.asdict(hcfg))
        return (lambda w: codec.encode(w).long()), hcfg.sampling_rate, hcfg.n_codes
    codec = load_codec("encodec_24k_240d", args.resume_path, device=args.device, n_filters=args.n_filters,
                       dimension=args.dimension, ratios=tuple(args.ratios), sample_rate=args.sr,
                       target_bandwidths=tuple(args.target_bandwidths), bins=args.bins)

    def encode(w):  # [n_q, B, frames] -> [B, frames, n_q]
        with torch.no_grad():
            return codec.encode(torch.as_tensor(w).to(codec.device), target_bw=args.target_bw).permute(1, 2, 0).long()

    return encode, args.sr, args.bins


def main(argv=None):
    args = get_args(argv)
    encode, sr, bins = codec_encoder(args)
    segment = int(args.segment_seconds * sr)
    # n_q at this bandwidth and the frames of a training crop, from a probe encode
    probe = encode(np.zeros((1, segment), np.float32))
    n_q, trained_frames = int(probe.shape[2]), int(probe.shape[1])
    cfg = LMTrainConfig(n_q=n_q, bins=bins, dim=args.lm_dim, num_heads=args.lm_heads, num_layers=args.lm_layers,
                        past_context=args.past_context, lr=args.lr,
                        decay_steps=args.steps if args.cosine_decay else None)
    trainer = LMTrainer(cfg, device=args.device)
    logger = Logger(args.path, args=vars(args))
    state = trainer.init_state(args.seed)

    def save():
        save_lm(state.lm, args.path, state.step, family=args.family, trained_frames=trained_frames)

    ds = WavCropDataset(args.train_data_path, segment, sample_rate=sr, seed=args.seed)
    for step_i, batch in enumerate(batch_iterator(ds, args.batch_size, seed=args.seed)):
        if step_i >= args.steps:
            break
        state, metrics = trainer.train_step(state, encode(batch))
        if step_i % args.print_freq == 0:
            logger.log_info(f"step {state.step} ce={float(metrics['ce_loss']):.4f} "
                            f"bits/token={float(metrics['bits_per_token']):.3f} (raw {np.log2(bins):.0f})")
        if state.step % args.checkpoint_interval == 0:
            save()
    save()
    logger.log_info(f"done at step {state.step}")
    logger.close()


if __name__ == "__main__":
    main()
