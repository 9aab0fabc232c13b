"""Discriminators of the Encodec/SoundStream trainer: MS-STFT, multi-period, multi-scale.

Each family returns ``(logits, fmaps)``: per sub-discriminator its logits
flattened to ``[B, n]`` and its list of feature maps. The maps are
channels-first (``[B, C, H, W]`` / ``[B, C, T]``), where the JAX package's
are channels-last; the flattened logits are in the same order in both.

The period and scale families come in two flavors: "soundstream" (thin
32-channel convs, no norm, LeakyReLU 0.2, reference
models/soundstream/models.py:14-160), which the Encodec/SoundStream trainer
uses, and "hificodec" (32 -> 1024 channels, weight norm, LeakyReLU 0.1;
the first scale spectral-normed, reference models/hificodec/models.py:
192-361), which the HiFi-Codec trainer uses. The multi-scale family's
``forward(x, advance=True)`` steps the spectral norm's ``u`` (``nn/conv.py``);
the trainer asks for it once a step.

Module names follow the JAX package's (``convs.0`` for ``convs_0``), so that
``utils/convert.discriminators_state_from_jax`` is a rename and a transpose.

Behavioral parity target: academicodec_tpu/nn/discriminators.py:43-358
(reference models/encodec/msstftd.py:27-178).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.nn.conv import Conv1d, Conv2d
from academicodec_tpu_torch.ops.stft import stft

DiscOutput = Tuple[List[torch.Tensor], List[List[torch.Tensor]]]

FLAVORS = ("soundstream", "hificodec")


def _check_flavor(flavor: str) -> None:
    if flavor not in FLAVORS:
        raise ValueError(f"unknown discriminator flavor {flavor!r}")


def _get_2d_padding(kernel_size, dilation=(1, 1)):
    return ((kernel_size[0] - 1) * dilation[0]) // 2, ((kernel_size[1] - 1) * dilation[1]) // 2


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Torch's default init of every conv under ``module``, drawn from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, (Conv1d, Conv2d)):
            m.reset_parameters(generator)


class STFTDiscriminator(nn.Module):
    """One resolution: the normalized complex STFT (center=False) as (real, imag)
    channels over ``[time, freq]``, then 2D convs (reference msstftd.py:27-134)."""

    def __init__(
        self,
        filters: int = 32,
        n_fft: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        in_channels: int = 1,
        out_channels: int = 1,
        max_filters: int = 1024,
        filters_scale: int = 1,
        kernel_size: Tuple[int, int] = (3, 9),
        dilations: Sequence[int] = (1, 2, 4),
        stride: Tuple[int, int] = (1, 2),
        norm: str = "weight_norm",
        activation_slope: float = 0.2,
    ):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.activation_slope = activation_slope
        ks = tuple(kernel_size)
        # the first conv has no norm in the reference (msstftd.py:84-89)
        convs = [Conv2d(2 * in_channels, filters, ks, padding=_get_2d_padding(ks), norm="none")]
        in_chs = min(filters_scale * filters, max_filters)
        for i, d in enumerate(dilations):
            out_chs = min((filters_scale ** (i + 1)) * filters, max_filters)
            convs.append(Conv2d(in_chs, out_chs, ks, stride=stride, dilation=(d, 1),
                                padding=_get_2d_padding(ks, (d, 1)), norm=norm))
            in_chs = out_chs
        out_chs = min((filters_scale ** (len(dilations) + 1)) * filters, max_filters)
        sq = (ks[0], ks[0])
        convs.append(Conv2d(in_chs, out_chs, sq, padding=_get_2d_padding(sq), norm=norm))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(out_chs, out_channels, sq, padding=_get_2d_padding(sq), norm=norm)

    def forward(self, x: torch.Tensor):
        s = stft(x, self.n_fft, self.hop_length, self.win_length, center=False, normalized=True)
        z = torch.stack([s.real, s.imag], dim=1).transpose(2, 3).to(x.dtype)  # [B, 2, frames, freq]
        fmap = []
        for conv in self.convs:
            z = F.leaky_relu(conv(z), self.activation_slope)
            fmap.append(z)
        logits = self.conv_post(z)
        return logits.reshape(logits.shape[0], -1), fmap


class MultiScaleSTFTDiscriminator(nn.Module):
    """STFT sub-discriminators at several resolutions (n_fft 1024, 2048, 512, 256, 128 by default)."""

    def __init__(
        self,
        filters: int = 32,
        n_ffts: Sequence[int] = (1024, 2048, 512, 256, 128),
        hop_lengths: Sequence[int] = (256, 512, 128, 64, 32),
        win_lengths: Sequence[int] = (1024, 2048, 512, 256, 128),
    ):
        super().__init__()
        self.discriminators = nn.ModuleList(
            STFTDiscriminator(filters=filters, n_fft=nf, hop_length=hl, win_length=wl)
            for nf, hl, wl in zip(n_ffts, hop_lengths, win_lengths)
        )

    def forward(self, x: torch.Tensor) -> DiscOutput:
        outs = [d(x) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]


class PeriodDiscriminator(nn.Module):
    """The wav folded by ``period`` into ``[B, 1, T / period, period]``, then
    ``(k, 1)`` convs strided along time."""

    def __init__(self, period: int, channels: Sequence[int] = (32, 32, 32, 32, 32), kernel_size: int = 5,
                 stride: int = 3, norm: str = "none", activation_slope: float = 0.2):
        super().__init__()
        self.period, self.activation_slope = period, activation_slope
        convs, in_ch = [], 1
        for i, out_ch in enumerate(channels):
            last = i == len(channels) - 1
            convs.append(Conv2d(in_ch, out_ch, (kernel_size, 1), stride=(1, 1) if last else (stride, 1),
                                padding=(2, 0), norm=norm))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(in_ch, 1, (3, 1), padding=(1, 0), norm=norm)

    def forward(self, x: torch.Tensor):
        B, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x[:, None, :], (0, p - T % p), mode="reflect")[:, 0, :]
        z = x.reshape(B, 1, -1, p)
        fmap = []
        for conv in self.convs:
            z = F.leaky_relu(conv(z), self.activation_slope)
            fmap.append(z)
        z = self.conv_post(z)
        fmap.append(z)
        return z.reshape(B, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Period sub-discriminators (periods 2, 3, 5, 7, 11 by default)."""

    def __init__(self, flavor: str = "soundstream", periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        _check_flavor(flavor)
        if flavor == "soundstream":
            kw = dict(channels=(32, 32, 32, 32, 32), norm="none", activation_slope=0.2)
        else:
            kw = dict(channels=(32, 128, 512, 1024, 1024), norm="weight_norm", activation_slope=0.1)
        self.discriminators = nn.ModuleList(PeriodDiscriminator(p, **kw) for p in periods)

    def forward(self, x: torch.Tensor) -> DiscOutput:
        outs = [d(x) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]


# (out channels, kernel, stride, groups, padding) of each conv, soundstream flavor
SS_SCALE_SPECS = (
    (32, 15, 1, 1, 7),
    (32, 41, 2, 4, 20),
    (32, 41, 2, 16, 20),
    (32, 41, 4, 16, 20),
    (32, 41, 4, 16, 20),
    (32, 41, 1, 16, 20),
    (32, 5, 1, 1, 2),
)
# the same, hificodec flavor
HC_SCALE_SPECS = (
    (128, 15, 1, 1, 7),
    (128, 41, 2, 4, 20),
    (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20),
    (1024, 41, 4, 16, 20),
    (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
)


class ScaleDiscriminator(nn.Module):
    """1D convs on the (possibly pooled) wav ``[B, 1, T]``."""

    def __init__(self, specs=SS_SCALE_SPECS, norm: str = "none", activation_slope: float = 0.2):
        super().__init__()
        self.activation_slope = activation_slope
        convs, in_ch = [], 1
        for out_ch, k, s, g, pad in specs:
            convs.append(Conv1d(in_ch, out_ch, k, stride=s, groups=g, padding=pad, norm=norm))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv1d(in_ch, 1, 3, padding=1, norm=norm)

    def forward(self, x: torch.Tensor, advance: bool = False):
        z = x[:, None, :]
        fmap = []
        for conv in self.convs:
            z = F.leaky_relu(conv(z, advance), self.activation_slope)
            fmap.append(z)
        z = self.conv_post(z, advance)
        fmap.append(z)
        return z.reshape(z.shape[0], -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """Scale sub-discriminators on the wav and on it average-pooled x2, x4, ...;
    in the hificodec flavor the first is spectral-normed, the others weight-normed."""

    def __init__(self, flavor: str = "soundstream", num_scales: int = 3):
        super().__init__()
        _check_flavor(flavor)
        if flavor == "soundstream":
            scales = [ScaleDiscriminator() for _ in range(num_scales)]
        else:
            scales = [ScaleDiscriminator(HC_SCALE_SPECS, "spectral_norm" if i == 0 else "weight_norm", 0.1)
                      for i in range(num_scales)]
        self.discriminators = nn.ModuleList(scales)

    def forward(self, x: torch.Tensor, advance: bool = False) -> DiscOutput:
        """``advance``: step the spectral norm's ``u`` in this call."""
        logits, fmaps = [], []
        z = x
        for i, d in enumerate(self.discriminators):
            if i:  # torch AvgPool1d: the divisor counts the zero padding
                z = F.avg_pool1d(z[:, None, :], 4, 2, padding=2)[:, 0, :]
            lg, fm = d(z, advance)
            logits.append(lg)
            fmaps.append(fm)
        return logits, fmaps
