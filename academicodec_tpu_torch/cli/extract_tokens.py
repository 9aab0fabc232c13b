"""HiFi-Codec token extraction and copy-synthesis CLI of the port.

Writes each wav's acoustic tokens ``{fid: [1, frames, 4]}`` to an ``.npz``
(``--tokens_out``; the VALL-E/SoundStorm hand-off, egs/HiFi-Codec-*/
infer.ipynb, with its ``--normalize`` peak convention), the reconstructed
wavs to ``--outputdir`` unless ``--no_synth`` (models/hificodec/
vqvae_copy_syn.py), and with ``--tokens_ecdc`` one ECDC token blob per file,
raw-packed, or LM-entropy-coded with ``--lm`` where that is smaller. The
flags and output files are those of ``academicodec_tpu/cli/extract_tokens.py``,
plus ``--device`` (the card unless ``cpu`` is asked for). The model computes
in f32 from a reference ``g_*`` checkpoint or a training state of the port's
``cli/train_hificodec.py`` (``state_<step>.pt``).

    python -m academicodec_tpu_torch.cli.extract_tokens --config config_24k_320d.json \\
        --model_path g_00100000 --input wavs/ --outputdir out/ --tokens_out tokens.npz \\
        --bucket_seconds 10 --batch_files 8

With ``--bucket_seconds`` each file is zero-padded to whole buckets and
encoded with its length (``VQVAE.encode(lengths=)``), so that its tokens equal
an exact-length encode; ``--batch_files`` encodes (and decodes) that many
same-bucket files per call.

``--int8_min_channels N`` serves the resblock convs of the stages of at least
N channels that the fused towers do not take (wider than 64) as W8A8 int8,
with activation scales calibrated on the first input file (peak-normalized
with ``--normalize``): the JAX CLI's ``--fused_resblock --int8_min_channels
N``. ``--lm`` takes a token-LM checkpoint directory of the port
(``models/lm.py``) of family ``hificodec``, with ``--tokens_ecdc``.

``--data_parallel`` runs each batched group's encode and synthesis over
several devices, one model replica a device, each taking an equal
contiguous block of the group (JAX ``run_batched(mesh=)``,
cli/extract_tokens.py:134-159, 332-341): every visible card for ``--device
cuda``, or the comma-separated list ``--device`` gives (``cpu,cpu`` runs two
replicas on the CPU). The masked encode is pointwise over the batch, so the
tokens equal one device's. ``--batch_files`` must be a multiple of the
device count.

``--sequence_parallel`` serves one file a call with its time axis cut into
one block a device (``parallel/sequence.TimeShardedVQVAE``), for few long
files: the encoder's GroupNorm statistics are summed over the blocks, the
rest moves data only. ``--device`` lists the devices as with
``--data_parallel`` and may name one several times; with
``--bucket_seconds`` each file is encoded with its length, as above.

Not ported: orbax checkpoint directories. The JAX CLI's ``--packed_conv``
and ``--fused_resblock`` choose TPU lowerings; the port accepts them and
runs its one path, in which the narrow stages always take the fused towers
(and, as the JAX CLI, refuses them with ``--sequence_parallel``).
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import sys

import numpy as np
import torch

from academicodec_tpu_torch.cli.compress import pipelined_groups, prefetch_reads
from academicodec_tpu_torch.codec.binary import read_ecdc_header
from academicodec_tpu_torch.codec.compress import compress_tokens_guarded
from academicodec_tpu_torch.data.dataset import list_audio_files
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.hificodec import VQVAE, calibrate_quant
from academicodec_tpu_torch.models.lm import load_lm
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.parallel.mesh import module_replicas, serving_devices, split_rows
from academicodec_tpu_torch.parallel.sequence import TimeShardedVQVAE
from academicodec_tpu_torch.utils.fold import fold_vqvae


def get_args(argv=None):
    p = argparse.ArgumentParser("extract_tokens")
    p.add_argument("--config", type=str, required=True, help="model config JSON")
    p.add_argument("--model_path", type=str, required=True,
                   help="reference g_* checkpoint file, or a state_<step>.pt of cli/train_hificodec.py")
    p.add_argument("--input", type=str, required=True, help="wav dir or filelist")
    p.add_argument("--outputdir", type=str, required=True)
    p.add_argument("--tokens_out", type=str, default=None, help=".npz path for tokens")
    p.add_argument("--tokens_ecdc", type=str, default=None,
                   help="directory: also write one ECDC token blob <fid>.ecdc per file ([n_q, T] in the "
                        "[l0g0, l0g1, l1g0, l1g1] stream order), raw-packed or LM-coded with --lm")
    p.add_argument("--lm", type=str, default=None,
                   help="token-LM checkpoint directory (lm_config.json + lm_<step>.pt, family hificodec) for "
                        "entropy-coded --tokens_ecdc blobs; a file keeps raw packing where that is smaller")
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--no_synth", action="store_true", help="tokens only")
    p.add_argument("--normalize", action="store_true", help="peak-normalize *0.95 (infer.ipynb convention)")
    p.add_argument("--packed_conv", action="store_true",
                   help="the JAX CLI's lanes-packed TPU lowering; the port accepts it and runs its one path")
    p.add_argument("--fused_resblock", action="store_true",
                   help="the JAX CLI's fused TPU towers; the port always fuses the stages of at most 64 channels")
    p.add_argument("--fold_weight_norm", action="store_true",
                   help="fold weight norm into plain weights (reference remove_weight_norm, "
                        "vqvae_copy_syn.py:33)")
    p.add_argument("--int8_min_channels", type=int, default=0,
                   help="W8A8 int8 serving of the resblock stages with at least this many channels that are "
                        "not fused (the fused towers take the stages of at most 64); 0 = off, 128 takes "
                        "hificodec_24k_320d's wide stages. Calibrates on the first input file. The JAX CLI's "
                        "--fused_resblock --int8_min_channels N")
    p.add_argument("--bucket_seconds", type=float, default=None,
                   help="pad inputs to multiples of this many seconds and encode each with its length, "
                        "so that a corpus of many lengths runs in a few shapes with exact tokens")
    p.add_argument("--batch_files", type=int, default=1,
                   help="encode (and synthesize) this many same-bucket files per call (requires "
                        "--bucket_seconds); partial groups are batch-padded")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard each batched group over the devices of --device (every visible card for cuda), "
                        "one model replica a device; --batch_files must be a multiple of the device count. "
                        "Tokens stay equal to one device's")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="cut each file's time axis into one block per device of --device (every visible card "
                        "for cuda), with halo exchanges between neighbours and the encoder's GroupNorm "
                        "statistics summed over the blocks: the mode for few long files. One file a call "
                        "(no --batch_files)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the card unless cpu is asked for. With --data_parallel or "
                        "--sequence_parallel, a comma-separated device list, or cuda for every visible card")
    args = p.parse_args(argv)
    if args.lm and not args.tokens_ecdc:
        p.error("--lm entropy-codes --tokens_ecdc blobs: pass --tokens_ecdc")
    if args.lm and not os.path.exists(args.lm):
        p.error(f"--lm: no LM checkpoint at {args.lm}")
    # the JAX CLI's checks (academicodec_tpu/cli/extract_tokens.py:100-115)
    if args.data_parallel and args.batch_files < 2:
        p.error("--data_parallel needs --batch_files >= the device count")
    if args.sequence_parallel and (args.data_parallel or args.batch_files > 1):
        p.error("--sequence_parallel shards time, not batch: drop --batch_files/--data_parallel")
    if args.sequence_parallel and (args.packed_conv or args.fused_resblock):
        p.error("--sequence_parallel needs the plain lowering: drop --packed_conv/--fused_resblock")
    if "," in args.device and not (args.data_parallel or args.sequence_parallel):
        p.error("--device lists several devices only with --data_parallel or --sequence_parallel")
    if args.batch_files > 1 and not args.bucket_seconds:
        p.error("--batch_files needs --bucket_seconds (uniform padded lengths per device batch)")
    if not os.path.isfile(args.model_path):
        p.error("--model_path must be a reference g_* file or a port training state (orbax directories "
                "are not ported)")
    return args


def read_config(args) -> HiFiCodecConfig:
    with open(args.config) as fh:
        return HiFiCodecConfig.from_json(json.load(fh))


def build_model(args, cfg: HiFiCodecConfig, device=None) -> VQVAE:
    model = VQVAE(cfg, device=device or args.device, int8_min_channels=args.int8_min_channels)
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


def run_batched(args, model: VQVAE, files, bucket: int, tokens: dict, devices=None) -> None:
    """One encode (and one decode) per group of ``batch_files`` same-bucket
    files, each row encoded with its length and trimmed to its exact frame
    count; the next group's encode is enqueued before this group's host half
    (JAX cli/extract_tokens.py:134-225). ``devices``: one model replica a
    device, each taking an equal contiguous block of every group."""
    hop, bf = model.hop_length, bucket // model.hop_length
    replicas = module_replicas(model, devices) if devices else [model]

    def enqueue(fn, *batch):
        """``fn(replica, *block)`` on each device's block of the rows, enqueued on
        every device before any result is fetched."""
        blocks = split_rows(len(batch[0]), len(replicas))
        return [fn(m, *(b[blk] for b in batch)) for m, blk in zip(replicas, blocks)]

    def gathered(outs):
        return torch.cat([o.cpu() for o in outs]).numpy()

    def submit(group):
        fids, wavs = zip(*group)
        Ts = [len(w) for w in wavs]
        Tpad = max(math.ceil(t / bucket) * bucket for t in Ts)
        rows = [np.pad(w, (0, Tpad - t)) for w, t in zip(wavs, Ts)]
        lens = list(Ts)
        while len(rows) < args.batch_files:  # batch-pad partial groups
            rows.append(np.zeros(Tpad, np.float32))
            lens.append(Tpad)
        return fids, Ts, enqueue(lambda m, w, n: m.encode(w, lengths=n), torch.from_numpy(np.stack(rows)),
                                 torch.tensor(lens))

    def complete(submitted):
        fids, Ts, codes_dev = submitted
        codes_b = gathered(codes_dev)
        items = []
        for i, (fid, T) in enumerate(zip(fids, Ts)):
            codes = codes_b[i:i + 1, :model.frames_for(T), :]
            tokens[fid] = codes
            items.append((fid, codes))
        if not args.no_synth:
            nb = math.ceil(max(c.shape[1] for _, c in items) / bf) * bf
            rows = [_edge_padded(c[0], nb) for _, c in items]
            rows += [rows[0]] * (args.batch_files - len(rows))
            outs = gathered(enqueue(lambda m, c: m.decode(c), torch.from_numpy(np.stack(rows))))
            for i, (fid, c) in enumerate(items):
                write_wav(os.path.join(args.outputdir, fid + ".wav"), outs[i, :c.shape[1] * hop], args.sample_rate)
        for fid, c in items:
            print(f"{fid}: tokens {c.shape}")

    def tagged_reads():
        for path, wav in prefetch_reads(files, args.sample_rate, depth=2 * args.batch_files):
            yield os.path.splitext(os.path.basename(path))[0], _normalized(args, wav)

    pipelined_groups(tagged_reads(), lambda wav: -(-len(wav) // bucket), args.batch_files, submit, complete)


def run_sequential(args, model: VQVAE, files, bucket, tokens: dict, devices=None) -> None:
    """One file a call; with a bucket, padded to whole buckets and encoded with its length.
    ``devices``: each file's time axis cut into one block a device (JAX
    cli/extract_tokens.py:353-411)."""
    hop = model.hop_length
    if devices:
        sharded = TimeShardedVQVAE(model, devices)

        def encode(w, lengths=None):
            return sharded.encode(w, lengths).gather()

        def decode(c):
            return sharded.decode(c).gather()
    else:
        encode, decode = model.encode, model.decode
    for path in files:
        fid = os.path.splitext(os.path.basename(path))[0]
        wav, sr = read_wav(path, sr=args.sample_rate)
        wav = _normalized(args, wav)
        if bucket:
            T = len(wav)
            padded = np.pad(wav, (0, math.ceil(T / bucket) * bucket - T))[None]
            codes = encode(torch.from_numpy(padded), lengths=torch.tensor([T])).cpu().numpy()
            codes = codes[:, :model.frames_for(T), :]
        else:
            codes = encode(torch.from_numpy(wav[None])).cpu().numpy()
        tokens[fid] = codes
        if not args.no_synth:
            n = codes.shape[1]
            if bucket:
                nb = math.ceil(n / (bucket // hop)) * (bucket // hop)
                out = decode(torch.from_numpy(_edge_padded(codes[0], nb)[None])).cpu().numpy()[0, :n * hop]
            else:
                out = decode(torch.from_numpy(codes)).cpu().numpy()[0]
            write_wav(os.path.join(args.outputdir, fid + ".wav"), out, sr)
        print(f"{fid}: tokens {codes.shape}")


def write_tokens_ecdc(args, cfg: HiFiCodecConfig, tokens: dict, lm=None) -> None:
    """One ECDC blob per file: the GRVQ streams ``[n_q, T]`` packed raw at
    ``ceil(log2(n_codes))`` bits, or LM-coded where ``lm`` makes the blob
    smaller (JAX cli/extract_tokens.py:228-264)."""
    bits = max(1, math.ceil(math.log2(cfg.n_codes)))
    os.makedirs(args.tokens_ecdc, exist_ok=True)
    lm_used = 0
    for fid, toks in tokens.items():
        c = np.asarray(toks)[0].T.astype(np.int32)  # [n_q, T], [l0g0, l0g1, l1g0, l1g1]
        blob = compress_tokens_guarded(c, bits_per_codebook=bits,
                                       metadata=dict(model="hificodec", sr=int(args.sample_rate)), lm=lm)
        with open(os.path.join(args.tokens_ecdc, fid + ".ecdc"), "wb") as fh:
            fh.write(blob)
        # the header's lm flag is the guard's decision
        lm_used += bool(lm is not None and read_ecdc_header(io.BytesIO(blob)).get("lm"))
        print(f"{fid}: {len(blob)} bytes, {len(blob) * 8 / c.size:.2f} bits/token (raw {bits})")
    if lm is not None:
        print(f"tokens_ecdc: LM coding won on {lm_used}/{len(tokens)} files (raw packing on the rest)")


def main(argv=None) -> dict:
    """Runs the CLI; returns the tokens ``{fid: [1, frames, 4]}``."""
    args = get_args(argv)
    cfg = read_config(args)
    devices = serving_devices(args.device) if args.data_parallel or args.sequence_parallel else None
    if args.data_parallel and args.batch_files % len(devices):
        sys.exit(f"--batch_files {args.batch_files} must be a multiple of the device count ({len(devices)}) for "
                 "--data_parallel")
    device = devices[0] if devices else args.device
    lm = None
    if args.lm:  # checked before the model loads
        try:
            lm, _ = load_lm(args.lm, expect_family="hificodec", expect_nq=2 * cfg.n_code_groups,
                            expect_bins=cfg.n_codes, device=device)
        except (ValueError, FileNotFoundError) as e:
            sys.exit(f"--lm: {e}")
    model = build_model(args, cfg, device)
    files = list_audio_files(args.input)
    if args.int8_min_channels:
        wav0, _ = read_wav(files[0], sr=args.sample_rate)
        # calibrate on what the model will see: --normalize peak-normalizes every input
        calibrate_quant(model, torch.from_numpy(_normalized(args, wav0)[None]))
    bucket = None
    if args.bucket_seconds:
        raw = max(1, int(round(args.bucket_seconds * args.sample_rate)))
        bucket = math.ceil(raw / model.hop_length) * model.hop_length
    os.makedirs(args.outputdir, exist_ok=True)
    tokens: dict = {}
    if args.batch_files > 1:
        run_batched(args, model, files, bucket, tokens, devices)
    else:
        run_sequential(args, model, files, bucket, tokens, devices)
    if args.tokens_out:
        np.savez(args.tokens_out, **tokens)
        print(f"wrote {len(tokens)} token tensors to {args.tokens_out}")
    if args.tokens_ecdc:
        write_tokens_ecdc(args, model.config, tokens, lm=lm)
    return tokens


if __name__ == "__main__":
    main()
