"""Batch compress/decompress CLI of the port (reference: models/encodec/test.py).

Round-trips every ``*.wav`` under ``--input`` through the codec and writes
the reconstructions to ``--output``; with ``--ecdc`` it also writes each
file's compressed ``.ecdc`` stream. The flags and output files are those of
``academicodec_tpu/cli/compress.py``, plus ``--device`` (the card unless
``cpu`` is asked for). The checkpoint is a reference PyTorch ``.pth`` (DDP
``module.`` prefixes removed, test.py:172-178) or a training checkpoint of
the port's ``cli/train_encodec.py`` (``latest_<step>.pt``, ``best_<step>.pt``).

    python -m academicodec_tpu_torch.cli.compress --input wavs/ --output out/ \\
        --resume_path best.pth --sr 24000 --ratios 6 5 4 2 \\
        --target_bandwidths 1 2 4 8 12 --target_bw 12 --dtype bf16 \\
        --ecdc --bucket_seconds 10 --batch_files 8 [--lm lm_dir/]

``--lm`` takes a token-LM checkpoint directory of the port
(``models/lm.py``: ``lm_config.json`` and ``lm_<step>.pt``) whose family is
``encodec`` and whose streams are those of ``--target_bw``; each file is
then LM-entropy-coded where that is smaller than raw packing.

``--data_parallel`` serves each batch over several devices, one model
replica a device (``SoundStreamCompressor(devices=)``): every visible card
for ``--device cuda``, or the comma-separated list ``--device`` gives
(``cuda:0,cuda:1``; ``cpu,cpu`` runs two replicas on the CPU). Blobs are
byte-identical to one device's. ``--batch_files`` must be a multiple of the
device count, as in the JAX CLI.

``--sequence_parallel`` instead cuts each file's time axis into one block a
device (``SoundStreamCompressor(devices=, shard_axis="time")``,
``parallel/sequence.py``), for few long files; ``--device`` lists the devices
the same way, and may name one several times. Blobs are byte-identical to
one device's.

Not ported: the JAX trainer's orbax checkpoint directories (the port's
trainer writes ``.pt`` files instead). ``--packed_conv`` selects a TPU
lowering; the port accepts it and runs its one path (and, as the JAX CLI,
refuses it with ``--sequence_parallel``).
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from academicodec_tpu_torch.api import reference_state_dict
from academicodec_tpu_torch.codec.compress import SoundStreamCompressor
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.lm import load_lm
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.parallel.mesh import serving_devices


def get_args(argv=None):
    p = argparse.ArgumentParser("compress")
    p.add_argument("--input", type=str, required=True, help="wav dir")
    p.add_argument("--output", type=str, required=True, help="output dir")
    p.add_argument("--resume_path", type=str, required=True,
                   help="reference .pth checkpoint, or a .pt training checkpoint of the port")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--ratios", type=int, nargs="+", default=[8, 5, 4, 2])
    p.add_argument("--target_bandwidths", type=float, nargs="+", default=[1, 1.5, 2, 4, 6, 12])
    p.add_argument("--target_bw", type=float, default=12)
    p.add_argument("--n_filters", type=int, default=32)
    p.add_argument("--dimension", type=int, default=512)
    p.add_argument("--bins", type=int, default=1024)
    p.add_argument("-r", "--rescale", action="store_true")
    p.add_argument("--packed_conv", action="store_true",
                   help="the JAX CLI's lanes-packed TPU lowering; the port accepts it and runs its one path")
    p.add_argument("--ecdc", action="store_true", help="also write .ecdc streams")
    p.add_argument("--lm", type=str, default=None,
                   help="token-LM checkpoint directory (lm_config.json + lm_<step>.pt, family encodec) for "
                        "entropy-coded streams; a file keeps raw packing where that is smaller")
    p.add_argument("--bucket_seconds", type=float, default=None,
                   help="pad inputs to multiples of this many seconds so that a corpus of "
                        "many lengths runs in a few batch shapes; the last few frames may "
                        "differ from an exact-length encode (codec/compress.py)")
    p.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                   help="serving precision: f32 is the reference-parity path, bf16 the fast one")
    p.add_argument("--batch_files", type=int, default=1,
                   help="encode/decode this many files per device call (requires "
                        "--bucket_seconds); files are grouped by bucket count and partial "
                        "groups batch-padded. Output order follows group completion")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard each serving batch over the devices of --device (every visible card for "
                        "cuda), one model replica a device; --batch_files must be a multiple of the device "
                        "count. Blobs stay byte-identical to one device's")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="cut each file's time axis into one block per device of --device (every visible card "
                        "for cuda), with halo exchanges between neighbours: the mode for few long files. "
                        "Blobs stay byte-identical to one device's. Excludes --data_parallel")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the card unless cpu is asked for. With --data_parallel or "
                        "--sequence_parallel, a comma-separated device list, or cuda for every visible card")
    args = p.parse_args(argv)
    # the JAX CLI's checks (academicodec_tpu/cli/compress.py:84-94)
    if args.sequence_parallel and args.data_parallel:
        p.error("--sequence_parallel and --data_parallel are mutually exclusive (shard time for few long "
                "files, batch for many short ones)")
    if args.sequence_parallel and args.packed_conv:
        p.error("--sequence_parallel needs the plain lowering: drop --packed_conv")
    if args.data_parallel and args.batch_files < 2:
        p.error("--data_parallel needs --batch_files >= the device count (one batch row per device at minimum)")
    if "," in args.device and not (args.data_parallel or args.sequence_parallel):
        p.error("--device lists several devices only with --data_parallel or --sequence_parallel")
    if args.lm and not os.path.exists(args.lm):
        p.error(f"--lm: no LM checkpoint at {args.lm}")
    if args.batch_files > 1 and not args.bucket_seconds:
        p.error("--batch_files needs --bucket_seconds (uniform padded lengths per device batch)")
    if not (os.path.isfile(args.resume_path) and args.resume_path.endswith((".pth", ".pt"))):
        p.error("--resume_path must be a reference .pth or a port training .pt file "
                "(orbax directories are not ported)")
    return args


def check_clipping(wav: np.ndarray, rescale: bool) -> None:
    if rescale:
        return
    mx = np.abs(wav).max()
    if mx > 0.99:
        print(f"Clipping!! max scale {mx}, limit is 0.99. Use -r to rescale.", file=sys.stderr)


def save_audio(wav: np.ndarray, path: str, sr: int, rescale: bool) -> None:
    limit = 0.99
    mx = np.abs(wav).max()
    if rescale:
        wav = wav * min(limit / max(mx, 1e-9), 1.0)
    else:
        wav = np.clip(wav, -limit, limit)
    write_wav(path, wav, sr)


def prefetch_reads(paths, sr: int, depth: int = 8):
    """Yield ``(path, wav)`` with up to ``depth`` file reads in flight on a
    worker thread, so that host IO overlaps device work."""
    depth = max(1, depth)
    with ThreadPoolExecutor(max_workers=1) as pool:
        inflight: deque = deque()
        it = iter(paths)
        for path in it:
            inflight.append((path, pool.submit(read_wav, path, sr=sr)))
            if len(inflight) >= depth:
                break
        while inflight:
            path, fut = inflight.popleft()
            nxt = next(it, None)
            if nxt is not None:
                inflight.append((nxt, pool.submit(read_wav, nxt, sr=sr)))
            yield path, fut.result()[0]


def pipelined_groups(items, group_key, group_size, submit, complete):
    """Collect ``(tag, wav)`` pairs into groups of ``group_size`` keyed by
    ``group_key(wav)`` (one padded device shape per group), enqueue each group
    with ``submit`` and run the host half (``complete``) one group behind, so
    that group N's device work overlaps group N-1's packing and writing.
    Trailing partial groups flush in insertion order."""
    pending: dict = {}
    inflight = None
    for tag, wav in items:
        key = group_key(wav)
        pending.setdefault(key, []).append((tag, wav))
        if len(pending[key]) >= group_size:
            submitted = submit(pending.pop(key))
            if inflight is not None:
                complete(inflight)
            inflight = submitted
    for group in pending.values():
        submitted = submit(group)
        if inflight is not None:
            complete(inflight)
        inflight = submitted
    if inflight is not None:
        complete(inflight)


def build_model(args, device=None) -> SoundStream:
    model = SoundStream(
        n_filters=args.n_filters, dimension=args.dimension, ratios=tuple(args.ratios),
        sample_rate=args.sr, target_bandwidths=tuple(args.target_bandwidths), bins=args.bins,
        device=device or args.device, dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
    )
    ckpt = torch.load(args.resume_path, map_location="cpu", weights_only=True)
    model.load_state_dict(reference_state_dict(ckpt))
    return model


def main(argv=None):
    args = get_args(argv)
    devices = serving_devices(args.device) if args.data_parallel or args.sequence_parallel else None
    if args.data_parallel and args.batch_files % len(devices):
        sys.exit(f"--batch_files {args.batch_files} must be a multiple of the device count ({len(devices)}) "
                 "for --data_parallel")
    device = devices[0] if devices else args.device
    model = build_model(args, device)
    lm = lm_trained_frames = None
    if args.lm:
        try:
            lm, lm_meta = load_lm(args.lm, expect_family="encodec", expect_nq=model.n_q_for_bandwidth(args.target_bw),
                                  expect_bins=model.bins, device=device)
        except (ValueError, FileNotFoundError) as e:
            sys.exit(f"--lm: {e}")
        lm_trained_frames = lm_meta.get("trained_frames")
    compressor = SoundStreamCompressor(model, target_bw=args.target_bw, bucket_seconds=args.bucket_seconds, lm=lm,
                                       devices=devices, shard_axis="time" if args.sequence_parallel else "batch")
    os.makedirs(args.output, exist_ok=True)
    names = sorted(f for f in os.listdir(args.input) if f.endswith(".wav"))
    warned_lm_len = False

    def warn_lm(name: str, n_samples: int) -> None:
        """Once: a file longer than the LM's training crops codes worse (JAX cli/compress.py:213-235)."""
        nonlocal warned_lm_len
        frames = -(-n_samples // model.hop_length)
        if lm_trained_frames and frames > lm_trained_frames and not warned_lm_len:
            warned_lm_len = True
            print(f"NOTE: {name} is {frames} frames but the LM was trained on {lm_trained_frames}-frame crops; "
                  "positions and context past the trained length are out of distribution and the LM-coded "
                  "rate degrades. Files do not grow past raw packing (the guard keeps the raw blob, "
                  "codec/compress.compress_tokens_guarded), but for the entropy-coding gain train on crops "
                  "as long as your files.", file=sys.stderr)

    def complete(submitted):
        """Host half of a group: fetch tokens, pack, decode, write."""
        gnames, wavs, codes_dev = submitted
        blobs = compressor.pack_submitted(codes_dev, [len(w) for w in wavs])
        outs = compressor.decompress_batch(blobs, pad_to_batch=args.batch_files)
        for name, wav, blob, (out, sr) in zip(gnames, wavs, blobs, outs):
            if args.ecdc:
                with open(os.path.join(args.output, name[:-4] + ".ecdc"), "wb") as fh:
                    fh.write(blob)
            check_clipping(out, args.rescale)
            save_audio(out, os.path.join(args.output, name), sr, args.rescale)
            print(f"{name}: {len(blob)} bytes ({8 * len(blob) / (len(wav) / args.sr) / 1000:.2f} kbps)")

    def submit(group):
        gnames, wavs = zip(*group)
        return gnames, wavs, compressor.submit_encode(list(wavs), pad_to_batch=args.batch_files)

    def named_reads():
        paths = [os.path.join(args.input, n) for n in names]
        for path, wav in prefetch_reads(paths, args.sr, depth=2 * args.batch_files):
            warn_lm(os.path.basename(path), len(wav))
            yield os.path.basename(path), wav

    pipelined_groups(
        named_reads(),
        lambda wav: -(-len(wav) // compressor.bucket) if compressor.bucket else len(wav),
        args.batch_files, submit, complete,
    )


if __name__ == "__main__":
    main()
