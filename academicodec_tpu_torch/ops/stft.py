"""STFT, spectrograms and mel filterbanks for the training losses.

The two front-end conventions of the JAX package (academicodec_tpu/ops/stft.py:65-251):

  * ``mel_spectrogram_torchaudio``: center=True reflect padding, the window
    zero-padded to ``n_fft``, power 2, HTK mel scale, no filterbank norm
    (torchaudio ``MelSpectrogram`` defaults; the Encodec/SoundStream
    reconstruction loss).
  * ``mel_spectrogram_hifigan``: a reflect pad of ``(n_fft - hop) / 2``,
    center=False, magnitude ``sqrt(|S|^2 + 1e-9)``, Slaney mel with Slaney
    norm, ``log(clamp(x, 1e-5))`` (the HiFi-GAN convention).

The filterbanks and windows are numpy constants, as in the JAX package. The
transform is ``torch.stft``: the JAX package's DFT matmul stands in for an
FFT only where its backend had none. ``torch.stft`` takes f32 or f64, so
other dtypes are upcast to f32 (the JAX CPU path does the same).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    f_safe = np.maximum(f, 1e-10)  # no log(0) in the branch np.where drops
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(f_safe / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=64)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank ``[n_mels, n_fft // 2 + 1]`` f32: ``htk=False,
    norm='slaney'`` is librosa's default, ``htk=True, norm=None`` torchaudio's.
    Callers must not write to the cached array."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        fb = fb * (2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=64)
def hann_window(win_length: int) -> np.ndarray:
    """``torch.hann_window(periodic=True)``, computed in f64 and stored f32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    pad_mode: str = "reflect",
    normalized: bool = False,
) -> torch.Tensor:
    """Complex STFT of ``[B, T]`` -> ``[B, n_fft // 2 + 1, frames]`` with a
    periodic Hann window of ``win_length`` (zero-padded to ``n_fft``);
    ``normalized`` divides by ``sqrt(sum(window^2))``, torchaudio's window norm
    (``torch.stft``'s own divides by ``sqrt(n_fft)``)."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    win = hann_window(win_length or n_fft)
    s = torch.stft(
        x, n_fft, hop_length=hop_length, win_length=win_length or n_fft,
        window=_const(win, x).to(x.dtype), center=center, pad_mode=pad_mode, return_complex=True,
    )
    return s / float(np.sqrt(np.sum(np.square(win, dtype=np.float32)))) if normalized else s


def spectrogram(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    power: Optional[float] = 2.0,
    center: bool = True,
    pad_mode: str = "reflect",
    normalized: bool = False,
) -> torch.Tensor:
    """Power (``power=2``), magnitude (``1``) or complex (``None``) spectrogram."""
    s = stft(x, n_fft, hop_length, win_length, center=center, pad_mode=pad_mode, normalized=normalized)
    if power is None:
        return s
    mag2 = s.real.square() + s.imag.square()
    return mag2 if power == 2.0 else mag2 ** (power / 2.0)


def mel_spectrogram_torchaudio(
    x: torch.Tensor,
    sr: int,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 2.0,
) -> torch.Tensor:
    """torchaudio ``MelSpectrogram`` defaults: ``[B, T] -> [B, n_mels, frames]``."""
    spec = spectrogram(x, n_fft, hop_length, win_length, power=power, center=True)
    fb = _const(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, True, None), spec).to(spec.dtype)
    return torch.matmul(fb, spec)


def mel_spectrogram_hifigan(
    x: torch.Tensor,
    n_fft: int,
    num_mels: int,
    sampling_rate: int,
    hop_size: int,
    win_size: int,
    fmin: float,
    fmax: Optional[float],
) -> torch.Tensor:
    """HiFi-GAN log-mel (reference meldataset.py:47-90): ``[B, T] -> [B, num_mels, frames]``."""
    pad = int((n_fft - hop_size) / 2)
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    s = stft(xp, n_fft, hop_size, win_size, center=False)
    mag = torch.sqrt(s.real.square() + s.imag.square() + 1e-9)
    fb = _const(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax, False, "slaney"), mag).to(mag.dtype)
    return torch.log(torch.clamp(torch.matmul(fb, mag), min=1e-5))
