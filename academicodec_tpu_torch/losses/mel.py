"""Multi-scale mel reconstruction losses (academicodec_tpu/losses/mel.py).

* ``mel_reconstruction_loss``, the Encodec/SoundStream loss (reference
  models/encodec/loss.py:60-84): ``lambda_wav * MSE(x, y) + sum_s [L1(mel_s)
  + sqrt(s / 2) * logRMSE(mel_s)]`` over scales ``s = 2^i``.
* ``hifigan_mel_losses``, the HiFi-Codec generator's mel terms (reference
  models/hificodec/train.py:219-275).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from academicodec_tpu_torch.ops.stft import mel_spectrogram_hifigan, mel_spectrogram_torchaudio


def mel_reconstruction_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    sr: int,
    scale_powers: Sequence[int] = range(6, 12),
    lambda_wav: float = 100.0,
    n_mels: int = 64,
    eps: float = 1e-7,
) -> torch.Tensor:
    """``x, y [B, T]`` waveforms -> scalar loss."""
    loss = lambda_wav * (x - y).square().mean()
    for i in scale_powers:
        s = 2**i
        kw = dict(n_fft=max(s, 512), hop_length=s // 4, win_length=s, n_mels=n_mels)
        sx = mel_spectrogram_torchaudio(x, sr, **kw)
        sy = mel_spectrogram_torchaudio(y, sr, **kw)
        l1 = (sx - sy).abs().mean()
        # the sqrt of each (batch, frame)'s mean over the mel axis, then the mean
        log_diff = torch.log(sx.abs() + eps) - torch.log(sy.abs() + eps)
        l2 = log_diff.square().mean(dim=-2).sqrt().mean()
        loss = loss + l1 + (s / 2) ** 0.5 * l2
    return loss


def hifigan_mel_losses(
    y: torch.Tensor,
    y_hat: torch.Tensor,
    y_mel: Optional[torch.Tensor],
    *,
    n_fft: int,
    num_mels: int,
    sampling_rate: int,
    hop_size: int,
    win_size: int,
    fmin: float,
    fmax_for_loss: Optional[float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(45 * L1(mel) + L1(mel_512) + L1(mel_256), L1(mel))``; ``y_mel`` is
    the ground truth's mel if the caller has it, else it is computed here."""
    cfg = dict(num_mels=num_mels, sampling_rate=sampling_rate, fmin=fmin, fmax=fmax_for_loss)
    if y_mel is None:
        y_mel = mel_spectrogram_hifigan(y, n_fft=n_fft, hop_size=hop_size, win_size=win_size, **cfg)
    y_hat_mel = mel_spectrogram_hifigan(y_hat, n_fft=n_fft, hop_size=hop_size, win_size=win_size, **cfg)
    mel_error = (y_mel - y_hat_mel).abs().mean()

    def small(sig, nf, hop):
        return mel_spectrogram_hifigan(sig, n_fft=nf, hop_size=hop, win_size=nf, **cfg)

    loss_mel1 = (small(y, 512, 120) - small(y_hat, 512, 120)).abs().mean()
    loss_mel2 = (small(y, 256, 60) - small(y_hat, 256, 60)).abs().mean()
    return mel_error * 45.0 + loss_mel1 + loss_mel2, mel_error
