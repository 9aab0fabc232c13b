"""Minimal WAV IO on the stdlib ``wave`` module (+ optional resampling).

The port's copy of ``academicodec_tpu/data/wavio.py``.

The environment has no soundfile/librosa/torchaudio; this covers the codec's
needs: PCM16/24/32 and float32 WAVs, mono mixdown, and polyphase resampling
via scipy. (Reference counterparts: librosa.load / soundfile.write usage in
models/encodec/test.py:20-31,111 and vqvae_tester.py:16-37.)
"""

from __future__ import annotations

import struct
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(
    path: str, sr: Optional[int] = None, mono: bool = True
) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 waveform in [-1, 1], sample_rate).

    If ``sr`` is given and differs from the file rate, resample (librosa.load
    semantics). Output shape ``[T]`` if mono else ``[C, T]``.
    """
    with open(path, "rb") as fh:
        header = fh.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk = fh.read(8)
            if len(chunk) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk)
            payload = fh.read(size)
            if size % 2:
                fh.read(1)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    elif audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported audio format {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels).T  # [C, T]
        if mono:
            x = x.mean(axis=0)

    if sr is not None and sr != rate:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(sr, rate)
        x = resample_poly(x, sr // g, rate // g, axis=-1).astype(np.float32)
        rate = sr
    return np.ascontiguousarray(x, dtype=np.float32), rate


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write float32 ``[T]`` or ``[C, T]`` in [-1, 1] as PCM16."""
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim == 2:
        channels = wav.shape[0]
        interleaved = wav.T.reshape(-1)
    else:
        channels = 1
        interleaved = wav
    pcm = np.clip(interleaved, -1.0, 1.0)
    pcm = (pcm * 32767.0).round().astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
