"""Whole-file compress/decompress on top of the ECDC container.

Device-side ``encode() -> tokens`` (on the card: the SEANet towers with K2
and the RVQ search K1), host-side bit packing into an ECDC stream, and the
inverse. The metadata header carries what is needed to rebuild the decoder
configuration.

Format: ECDC header (JSON metadata: model family, sr, ratios, bandwidth,
n_frames, audio_length) followed by the codebook indices packed LSB-first at
``bits_per_codebook`` bits, layer-major (codes[k, t] iterated k, t), one
stream per file. Blobs are byte-identical to the JAX package's on the same
weights and wav. With a token LM (``models/lm.py``), a file is also
LM-entropy-coded (``codec/lm_compress.py``) and whichever blob is smaller is
kept; the header's ``lm`` flag tells the decoder which it got.

``devices`` serves data-parallel: one replica of the model per device, each
batch cut into one equal contiguous block per device, every block enqueued
on its own device before any is fetched, and the codes gathered to the host
in order (JAX ``SoundStreamCompressor(mesh=)``, codec/compress.py:116-149,
``_shard`` :252-271). The graph is pointwise over the batch, so blobs are
byte-identical to one device's. ``shard_axis="time"`` instead cuts each
batch's time axis into one block per device (``parallel/sequence.py``,
``TimeShardedSoundStream``), for few long files: tokens, and so blobs, stay
those of one device (JAX codec/compress.py:117-142).

Behavioral parity target: academicodec_tpu/codec/compress.py:31-350.
"""

from __future__ import annotations

import io
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from academicodec_tpu_torch.codec.binary import (
    pack_array,
    read_ecdc_header,
    unpack_array,
    write_ecdc_header,
)
from academicodec_tpu_torch.codec.lm_compress import compress_tokens_with_lm, decompress_tokens_with_lm
from academicodec_tpu_torch.parallel.mesh import module_replicas, split_rows
from academicodec_tpu_torch.parallel.sequence import TimeShardedSoundStream


def compress_codes(codes: np.ndarray, *, bits_per_codebook: int, metadata: dict) -> bytes:
    """codes ``[n_q, T]`` int -> ECDC byte stream."""
    n_q, n_frames = codes.shape
    fo = io.BytesIO()
    meta = dict(metadata)
    meta.update(n_q=int(n_q), n_frames=int(n_frames), bits=int(bits_per_codebook))
    write_ecdc_header(fo, meta)
    fo.write(pack_array(np.asarray(codes).reshape(-1), bits_per_codebook))
    return fo.getvalue()


def decompress_codes(blob: bytes) -> Tuple[np.ndarray, dict]:
    """ECDC byte stream -> (codes ``[n_q, T]`` int32, metadata)."""
    fo = io.BytesIO(blob)
    meta = read_ecdc_header(fo)
    n_q, n_frames, bits = meta["n_q"], meta["n_frames"], meta["bits"]
    out = unpack_array(fo.read(), bits, n_q * n_frames)
    return out.reshape(n_q, n_frames), meta


def compress_tokens_guarded(codes: np.ndarray, *, bits_per_codebook: int, metadata: dict, lm=None) -> bytes:
    """codes ``[n_q, T]`` -> ECDC bytes: raw-packed, or LM-entropy-coded when
    ``lm`` is given and that blob is smaller. An LM fed streams unlike its
    training data (longer, or another codec's) can code past raw packing,
    so the raw blob is always built and the smaller one kept (JAX
    codec/compress.py:56-81)."""
    raw = compress_codes(codes, bits_per_codebook=bits_per_codebook, metadata=metadata)
    if lm is not None:
        lm_blob = compress_tokens_with_lm(lm, codes, metadata=metadata)
        if len(lm_blob) < len(raw):
            return lm_blob
    return raw


def decompress_tokens(blob: bytes, lm=None) -> Tuple[np.ndarray, dict]:
    """Inverse of :func:`compress_tokens_guarded`: the header's ``lm`` flag
    selects raw unpacking or LM decoding, which needs ``lm``."""
    if read_ecdc_header(io.BytesIO(blob)).get("lm"):
        if lm is None:
            raise ValueError("stream is LM-entropy-coded; pass lm (cli: --lm <checkpoint dir>)")
        return decompress_tokens_with_lm(lm, blob)
    return decompress_codes(blob)


class SoundStreamCompressor:
    """File-level compression API for a SoundStream/Encodec model of the port.

    Mirrors the reference compression CLI (models/encodec/test.py:102-123)
    plus the ECDC container, batching and length bucketing.

    ``bucket_seconds`` zero-pads inputs up to the next bucket multiple
    (rounded to whole hops), so that files of many lengths share a few batch
    shapes, and edge-replicates token streams up to whole buckets on decode;
    outputs are trimmed back to each file's exact frame and sample counts.
    The non-causal encoder's tail then sees zeros instead of reflect
    padding, so the last few frames may differ from an exact-length encode.

    ``lm``: a token LM of the model's streams at ``target_bw``; each blob is
    then LM-coded where that is smaller (:func:`compress_tokens_guarded`).

    ``devices``: serve over these devices (module docstring), data-parallel
    (``shard_axis="batch"``; a batch must then divide by their count) or
    time-sharded (``shard_axis="time"``).
    """

    def __init__(self, model, target_bw: Optional[float] = None, bucket_seconds: Optional[float] = None,
                 lm=None, devices: Optional[Sequence] = None, shard_axis: str = "batch"):
        if shard_axis not in ("batch", "time"):
            raise ValueError(f"shard_axis must be 'batch' or 'time', got {shard_axis!r}")
        self.model = model
        self.lm = lm
        self.target_bw = target_bw if target_bw is not None else model.target_bandwidths[-1]
        time_sharded = bool(devices) and shard_axis == "time"
        self.sequence = TimeShardedSoundStream(model, devices, self.target_bw) if time_sharded else None
        self.replicas = module_replicas(model, devices) if devices and not time_sharded else [model]
        self.bucket = None
        if bucket_seconds:
            hop = model.hop_length
            raw = max(1, int(round(bucket_seconds * model.sample_rate)))
            self.bucket = math.ceil(raw / hop) * hop

    def _exact_frames(self, T: int) -> int:
        """Token frames an exact-length encode of ``T`` samples yields
        (ceil-mode padded SEANet stack -> ceil(T / hop))."""
        return math.ceil(T / self.model.hop_length)

    def _meta(self, T: int) -> dict:
        return dict(
            model="soundstream",
            sr=int(self.model.sample_rate),
            ratios=[int(r) for r in self.model.ratios],
            target_bw=float(self.target_bw),
            audio_length=int(T),
        )

    def compress(self, wav: np.ndarray) -> bytes:
        """wav ``[T]`` float32 -> ECDC bytes."""
        return self.compress_batch([wav])[0]

    def compress_batch(self, wavs: Sequence[np.ndarray], pad_to_batch: Optional[int] = None) -> List[bytes]:
        """List of ``[T_i]`` wavs -> list of ECDC blobs through one encode.
        Items are padded to the longest bucket in the batch; ``pad_to_batch``
        zero-pads the batch dimension to a fixed size (pad rows are encoded
        and dropped). Each blob equals that of a ``compress`` call of the same
        padded length."""
        return self.pack_submitted(self.submit_encode(wavs, pad_to_batch=pad_to_batch),
                                   [int(w.shape[-1]) for w in wavs])

    def submit_encode(self, wavs: Sequence[np.ndarray], pad_to_batch: Optional[int] = None) -> List[torch.Tensor]:
        """Device half of :meth:`compress_batch`: pad and stack the batch and
        enqueue the encode; returns the codes ``[n_q, B, frames]`` as one block
        a device, on that device (time-sharded: the whole codes on the first
        device), without waiting for them. Pair with :meth:`pack_submitted`."""
        Ts = [int(w.shape[-1]) for w in wavs]
        Tmax = max(Ts)
        if self.bucket:
            Tpad = math.ceil(Tmax / self.bucket) * self.bucket
        else:
            if len(set(Ts)) > 1:
                raise ValueError("compress_batch with mixed lengths requires bucket_seconds")
            Tpad = Tmax
        rows = [np.pad(np.asarray(w, np.float32), (0, Tpad - t)) for w, t in zip(wavs, Ts)]
        if pad_to_batch and len(rows) < pad_to_batch:
            rows += [np.zeros(Tpad, np.float32)] * (pad_to_batch - len(rows))
        batch = torch.from_numpy(np.stack(rows))
        if self.sequence is not None:
            return [self.sequence.encode(batch).gather()]
        return [m.encode(batch[blk], target_bw=self.target_bw)
                for m, blk in zip(self.replicas, split_rows(len(batch), len(self.replicas)))]

    def pack_submitted(self, codes_dev: Sequence[torch.Tensor], lengths: Sequence[int]) -> List[bytes]:
        """Host half of :meth:`compress_batch`: fetch the codes of
        :meth:`submit_encode` (in device order) and pack one ECDC blob per item."""
        codes = torch.cat([c.cpu() for c in codes_dev], dim=1).numpy()
        return [
            compress_tokens_guarded(
                codes[:, i, : self._exact_frames(int(T))],
                bits_per_codebook=self.model.bits_per_codebook,
                metadata=self._meta(int(T)),
                lm=self.lm,
            )
            for i, T in enumerate(lengths)
        ]

    def decompress(self, blob: bytes) -> Tuple[np.ndarray, int]:
        """ECDC bytes -> (wav ``[T]`` float32, sample_rate)."""
        return self.decompress_batch([blob])[0]

    def decompress_batch(self, blobs: Sequence[bytes], pad_to_batch: Optional[int] = None) -> list:
        """Batched inverse of :meth:`compress_batch`: list of ECDC blobs -> list
        of ``(wav [T], sample_rate)`` through one decode. Streams are padded
        (by repeating their last frame) to the longest whole bucket in the
        batch and trimmed back to each item's ``audio_length``."""
        items = [decompress_tokens(blob, lm=self.lm) for blob in blobs]
        n_qs = {c.shape[0] for c, _ in items}
        if len(n_qs) > 1:
            raise ValueError(f"decompress_batch needs a uniform codebook count, got {n_qs}")
        bf = self.bucket // self.model.hop_length if self.bucket else 1
        nmax = max(c.shape[-1] for c, _ in items)
        nb = math.ceil(nmax / bf) * bf
        rows = []
        for codes, _ in items:
            n = codes.shape[-1]
            if nb > n:
                codes = np.concatenate([codes, np.repeat(codes[:, -1:], nb - n, axis=-1)], axis=-1)
            rows.append(codes)
        if pad_to_batch and len(rows) < pad_to_batch:
            rows += [rows[0]] * (pad_to_batch - len(rows))
        codes = torch.from_numpy(np.stack(rows, axis=1))
        if self.sequence is not None:
            blocks = [self.sequence.decode(codes).gather()]
        else:
            blocks = [m.decode(codes[:, blk])
                      for m, blk in zip(self.replicas, split_rows(codes.shape[1], len(self.replicas)))]
        wavs = torch.cat([w.float().cpu() for w in blocks]).numpy()
        out = []
        for i, (_, meta) in enumerate(items):
            wav = wavs[i]
            if "audio_length" in meta:  # trim the ceil-mode padding back to the original length
                wav = wav[: meta["audio_length"]]
            out.append((wav, meta["sr"]))
        return out
