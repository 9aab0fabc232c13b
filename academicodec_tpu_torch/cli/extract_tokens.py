"""HiFi-Codec token extraction and copy-synthesis CLI of the port.

Writes each wav's acoustic tokens ``{fid: [1, frames, 4]}`` to an ``.npz``
(``--tokens_out``; the VALL-E/SoundStorm hand-off, egs/HiFi-Codec-*/
infer.ipynb, with its ``--normalize`` peak convention), the reconstructed
wavs to ``--outputdir`` unless ``--no_synth`` (models/hificodec/
vqvae_copy_syn.py), and with ``--tokens_ecdc`` one raw-packed ECDC token blob
per file. The flags and output files are those of
``academicodec_tpu/cli/extract_tokens.py``, plus ``--device`` (the card unless
``cpu`` is asked for). The model computes in f32 from a reference ``g_*``
checkpoint.

    python -m academicodec_tpu_torch.cli.extract_tokens --config config_24k_320d.json \\
        --model_path g_00100000 --input wavs/ --outputdir out/ --tokens_out tokens.npz \\
        --bucket_seconds 10 --batch_files 8

With ``--bucket_seconds`` each file is zero-padded to whole buckets and
encoded with its length (``VQVAE.encode(lengths=)``), so that its tokens equal
an exact-length encode; ``--batch_files`` encodes (and decodes) that many
same-bucket files per call. Not ported yet: ``--lm`` (LM entropy coding,
ROADMAP.md Queue 1 item 8), ``--int8_min_channels`` (W8A8 serving, item 3),
``--data_parallel`` and ``--sequence_parallel`` (item 9), orbax checkpoint
directories. The JAX CLI's ``--packed_conv`` and ``--fused_resblock`` choose
TPU lowerings, which the port does not carry.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from academicodec_tpu_torch.cli.compress import pipelined_groups, prefetch_reads
from academicodec_tpu_torch.codec.compress import compress_tokens_guarded
from academicodec_tpu_torch.data.dataset import list_audio_files
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.utils.fold import fold_vqvae


def get_args(argv=None):
    p = argparse.ArgumentParser("extract_tokens")
    p.add_argument("--config", type=str, required=True, help="model config JSON")
    p.add_argument("--model_path", type=str, required=True, help="reference g_* checkpoint file")
    p.add_argument("--input", type=str, required=True, help="wav dir or filelist")
    p.add_argument("--outputdir", type=str, required=True)
    p.add_argument("--tokens_out", type=str, default=None, help=".npz path for tokens")
    p.add_argument("--tokens_ecdc", type=str, default=None,
                   help="directory: also write one raw-packed ECDC token blob <fid>.ecdc per file "
                        "([n_q, T] in the [l0g0, l0g1, l1g0, l1g1] stream order)")
    p.add_argument("--lm", type=str, default=None, help="not ported yet (LM entropy coding)")
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--no_synth", action="store_true", help="tokens only")
    p.add_argument("--normalize", action="store_true", help="peak-normalize *0.95 (infer.ipynb convention)")
    p.add_argument("--fold_weight_norm", action="store_true",
                   help="fold weight norm into plain weights (reference remove_weight_norm, "
                        "vqvae_copy_syn.py:33)")
    p.add_argument("--int8_min_channels", type=int, default=0, help="not ported yet (W8A8 serving); 0 only")
    p.add_argument("--bucket_seconds", type=float, default=None,
                   help="pad inputs to multiples of this many seconds and encode each with its length, "
                        "so that a corpus of many lengths runs in a few shapes with exact tokens")
    p.add_argument("--batch_files", type=int, default=1,
                   help="encode (and synthesize) this many same-bucket files per call (requires "
                        "--bucket_seconds); partial groups are batch-padded")
    p.add_argument("--data_parallel", action="store_true", help="not ported yet (multi-GPU serving)")
    p.add_argument("--sequence_parallel", action="store_true", help="not ported yet (multi-GPU serving)")
    p.add_argument("--device", type=str, default="cuda", help="torch device; the card unless cpu is asked for")
    args = p.parse_args(argv)
    if args.lm:
        p.error("--lm: LM entropy coding is not ported yet (ROADMAP.md Queue 1 item 8)")
    if args.int8_min_channels > 0:
        p.error("--int8_min_channels: W8A8 int8 serving is not ported yet (ROADMAP.md Queue 1 item 3)")
    if args.data_parallel or args.sequence_parallel:
        p.error("--data_parallel/--sequence_parallel: multi-GPU serving is not ported yet "
                "(ROADMAP.md Queue 1 item 9)")
    if args.batch_files > 1 and not args.bucket_seconds:
        p.error("--batch_files needs --bucket_seconds (uniform padded lengths per device batch)")
    if not os.path.isfile(args.model_path):
        p.error("--model_path must be a reference g_* file (orbax directories are not ported)")
    return args


def build_model(args) -> VQVAE:
    with open(args.config) as fh:
        cfg = HiFiCodecConfig.from_json(json.load(fh))
    model = VQVAE(cfg, device=args.device)
    model.load_reference(torch.load(args.model_path, map_location="cpu", weights_only=True))
    return fold_vqvae(model) if args.fold_weight_norm else model


def _normalized(args, wav: np.ndarray) -> np.ndarray:
    if args.normalize:
        peak = np.abs(wav).max() or 1.0
        wav = wav / peak * 0.95
    return wav


def _edge_padded(codes: np.ndarray, frames: int) -> np.ndarray:
    """``codes [n, 4]`` with its last frame repeated up to ``frames`` frames."""
    n = codes.shape[0]
    return np.concatenate([codes, np.repeat(codes[-1:], frames - n, axis=0)]) if frames > n else codes


def run_batched(args, model: VQVAE, files, bucket: int, tokens: dict) -> None:
    """One encode (and one decode) per group of ``batch_files`` same-bucket
    files, each row encoded with its length and trimmed to its exact frame
    count; the next group's encode is enqueued before this group's host half
    (JAX cli/extract_tokens.py:134-225)."""
    hop, bf = model.hop_length, bucket // model.hop_length

    def submit(group):
        fids, wavs = zip(*group)
        Ts = [len(w) for w in wavs]
        Tpad = max(math.ceil(t / bucket) * bucket for t in Ts)
        rows = [np.pad(w, (0, Tpad - t)) for w, t in zip(wavs, Ts)]
        lens = list(Ts)
        while len(rows) < args.batch_files:  # batch-pad partial groups
            rows.append(np.zeros(Tpad, np.float32))
            lens.append(Tpad)
        return fids, Ts, model.encode(torch.from_numpy(np.stack(rows)), lengths=torch.tensor(lens))

    def complete(submitted):
        fids, Ts, codes_dev = submitted
        codes_b = codes_dev.cpu().numpy()
        items = []
        for i, (fid, T) in enumerate(zip(fids, Ts)):
            codes = codes_b[i:i + 1, :model.frames_for(T), :]
            tokens[fid] = codes
            items.append((fid, codes))
        if not args.no_synth:
            nb = math.ceil(max(c.shape[1] for _, c in items) / bf) * bf
            rows = [_edge_padded(c[0], nb) for _, c in items]
            rows += [rows[0]] * (args.batch_files - len(rows))
            outs = model.decode(torch.from_numpy(np.stack(rows))).cpu().numpy()
            for i, (fid, c) in enumerate(items):
                write_wav(os.path.join(args.outputdir, fid + ".wav"), outs[i, :c.shape[1] * hop], args.sample_rate)
        for fid, c in items:
            print(f"{fid}: tokens {c.shape}")

    def tagged_reads():
        for path, wav in prefetch_reads(files, args.sample_rate, depth=2 * args.batch_files):
            yield os.path.splitext(os.path.basename(path))[0], _normalized(args, wav)

    pipelined_groups(tagged_reads(), lambda wav: -(-len(wav) // bucket), args.batch_files, submit, complete)


def run_sequential(args, model: VQVAE, files, bucket, tokens: dict) -> None:
    """One file a call; with a bucket, padded to whole buckets and encoded with its length."""
    hop = model.hop_length
    for path in files:
        fid = os.path.splitext(os.path.basename(path))[0]
        wav, sr = read_wav(path, sr=args.sample_rate)
        wav = _normalized(args, wav)
        if bucket:
            T = len(wav)
            padded = np.pad(wav, (0, math.ceil(T / bucket) * bucket - T))[None]
            codes = model.encode(torch.from_numpy(padded), lengths=torch.tensor([T])).cpu().numpy()
            codes = codes[:, :model.frames_for(T), :]
        else:
            codes = model.encode(torch.from_numpy(wav[None])).cpu().numpy()
        tokens[fid] = codes
        if not args.no_synth:
            n = codes.shape[1]
            if bucket:
                nb = math.ceil(n / (bucket // hop)) * (bucket // hop)
                out = model.decode(torch.from_numpy(_edge_padded(codes[0], nb)[None])).cpu().numpy()[0, :n * hop]
            else:
                out = model.decode(torch.from_numpy(codes)).cpu().numpy()[0]
            write_wav(os.path.join(args.outputdir, fid + ".wav"), out, sr)
        print(f"{fid}: tokens {codes.shape}")


def write_tokens_ecdc(args, cfg: HiFiCodecConfig, tokens: dict) -> None:
    """One ECDC blob per file: the GRVQ streams ``[n_q, T]`` packed raw at
    ``ceil(log2(n_codes))`` bits (JAX cli/extract_tokens.py:228-264, without an LM)."""
    bits = max(1, math.ceil(math.log2(cfg.n_codes)))
    os.makedirs(args.tokens_ecdc, exist_ok=True)
    for fid, toks in tokens.items():
        c = np.asarray(toks)[0].T.astype(np.int32)  # [n_q, T], [l0g0, l0g1, l1g0, l1g1]
        blob = compress_tokens_guarded(c, bits_per_codebook=bits,
                                       metadata=dict(model="hificodec", sr=int(args.sample_rate)))
        with open(os.path.join(args.tokens_ecdc, fid + ".ecdc"), "wb") as fh:
            fh.write(blob)
        print(f"{fid}: {len(blob)} bytes, {len(blob) * 8 / c.size:.2f} bits/token (raw {bits})")


def main(argv=None) -> dict:
    """Runs the CLI; returns the tokens ``{fid: [1, frames, 4]}``."""
    args = get_args(argv)
    model = build_model(args)
    files = list_audio_files(args.input)
    bucket = None
    if args.bucket_seconds:
        raw = max(1, int(round(args.bucket_seconds * args.sample_rate)))
        bucket = math.ceil(raw / model.hop_length) * model.hop_length
    os.makedirs(args.outputdir, exist_ok=True)
    tokens: dict = {}
    if args.batch_files > 1:
        run_batched(args, model, files, bucket, tokens)
    else:
        run_sequential(args, model, files, bucket, tokens)
    if args.tokens_out:
        np.savez(args.tokens_out, **tokens)
        print(f"wrote {len(tokens)} token tensors to {args.tokens_out}")
    if args.tokens_ecdc:
        write_tokens_ecdc(args, model.config, tokens)
    return tokens


if __name__ == "__main__":
    main()
