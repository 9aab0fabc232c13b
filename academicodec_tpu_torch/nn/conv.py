"""Conv layers with weight norm and streaming-safe padding, on ``[B, C, T]``.

Parameters use the reference PyTorch layouts and names: ``weight_v`` /
``weight_g`` (torch ``weight_norm(dim=0)``) or a plain ``weight``, with
``[O, I, K]`` conv and ``[I, O, K]`` conv-transpose kernels. Weight norm is
resolved on every call as ``g * v / ||v||`` with no eps, exactly as
``academicodec_tpu/nn/conv.py`` does: per out-channel for conv, per
in-channel for conv-transpose.

``NormConv1d`` / ``NormConvTranspose1d`` only add the reference's extra
module level, so state-dict keys read ``conv.conv.weight_v`` and
``convtr.convtr.weight_v`` as in a reference checkpoint.

Behavioral parity targets: academicodec_tpu/nn/conv.py (SConv1d,
SConvTranspose1d); reference academicodec/modules/conv.py:213-323.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.ops.padding import get_extra_padding_for_conv1d, pad1d, unpad1d

NORMS = ("none", "weight_norm")


class _NormedWeight(nn.Module):
    """A kernel held either plain (``weight``) or weight-normed (``weight_v``/``weight_g``)."""

    def _make_weight(self, shape, norm: str) -> None:
        if norm not in NORMS:
            raise ValueError(f"unsupported norm {norm!r}; the port has {NORMS}")
        self.norm = norm
        if norm == "weight_norm":
            self.weight_v = nn.Parameter(torch.empty(shape))
            self.weight_g = nn.Parameter(torch.empty(shape[0], 1, 1))
        else:
            self.weight = nn.Parameter(torch.empty(shape))

    def _init_weight(self, generator: torch.Generator, fan_in: int, normal_std=None) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            w = self.weight_v if self.norm == "weight_norm" else self.weight
            if normal_std is None:
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))
            else:
                w.copy_(torch.empty(w.shape).normal_(0.0, normal_std, generator=generator))
            if self.norm == "weight_norm":  # g <- ||v||: the initial weight equals v
                self.weight_g.copy_(_channel_norm(w))
            if self.bias is not None:
                self.bias.copy_(
                    torch.empty(self.bias.shape).uniform_(-bound, bound, generator=generator)
                )

    def resolved_weight(self) -> torch.Tensor:
        if self.norm == "weight_norm":
            return self.weight_g * self.weight_v / _channel_norm(self.weight_v)
        return self.weight


def _channel_norm(v: torch.Tensor) -> torch.Tensor:
    return v.square().sum(dim=(1, 2), keepdim=True).sqrt()


class Conv1d(_NormedWeight):
    """Cross-correlation over ``[B, C, T]`` with a ``[O, I/groups, K]`` kernel
    and ``padding`` zeros on each side (the HiFi-Codec convs' fixed "same"
    padding; academicodec_tpu/nn/conv.py:128-229)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        norm: str = "none",
        padding: int = 0,
    ):
        super().__init__()
        self.stride, self.dilation, self.groups, self.padding = stride, dilation, groups, padding
        self.fan_in = (in_channels // groups) * kernel_size
        self._make_weight((out_channels, in_channels // groups, kernel_size), norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator: torch.Generator, normal_std=None) -> None:
        """Torch's default uniform init, or N(0, normal_std^2) weights."""
        self._init_weight(generator, self.fan_in, normal_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(
            x, self.resolved_weight(), self.bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
        )


class ConvTranspose1d(_NormedWeight):
    """Transposed conv over ``[B, C, T]`` with an ``[I, O, K]`` kernel; ``padding``
    has torch's meaning, that much output cut from each side
    (academicodec_tpu/nn/conv.py:231-321)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        bias: bool = True,
        norm: str = "none",
        padding: int = 0,
    ):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.fan_in = out_channels * kernel_size  # torch convT fan_in = out * k
        self._make_weight((in_channels, out_channels, kernel_size), norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator: torch.Generator, normal_std=None) -> None:
        """Torch's default uniform init, or N(0, normal_std^2) weights."""
        self._init_weight(generator, self.fan_in, normal_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(
            x, self.resolved_weight(), self.bias, stride=self.stride, padding=self.padding
        )


class NormConv1d(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()
        self.conv = Conv1d(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class NormConvTranspose1d(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()
        self.convtr = ConvTranspose1d(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convtr(x)


class SConv1d(nn.Module):
    """Conv1d with causal or centred padding that keeps the framing exact.

    ``padding_total = (k-1)*d - (s-1)``; causal puts it all on the left,
    otherwise ``left = total - total//2``. Extra right padding makes the
    last window full, so encode/decode round trips preserve length.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        causal: bool = False,
        norm: str = "weight_norm",
        pad_mode: str = "reflect",
    ):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.causal, self.pad_mode = causal, pad_mode
        self.conv = NormConv1d(
            in_channels, out_channels, kernel_size, stride=stride, dilation=dilation,
            groups=groups, bias=bias, norm=norm,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.kernel_size, self.stride, self.dilation
        padding_total = (k - 1) * d - (s - 1)
        extra = get_extra_padding_for_conv1d(x.shape[-1], k, s, padding_total)
        if self.causal:
            pads = (padding_total, extra)
        else:
            pad_right = padding_total // 2
            pads = (padding_total - pad_right, pad_right + extra)
        return self.conv(pad1d(x, pads, mode=self.pad_mode))


class SConvTranspose1d(nn.Module):
    """ConvTranspose1d whose ``k - s`` surplus samples are trimmed:
    ``ceil(total * trim_right_ratio)`` on the right when causal, otherwise
    ``total//2`` on the right and the rest on the left."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        causal: bool = False,
        trim_right_ratio: float = 1.0,
        bias: bool = True,
        norm: str = "weight_norm",
    ):
        super().__init__()
        if not (causal or trim_right_ratio == 1.0):
            raise ValueError("trim_right_ratio != 1 needs a causal conv-transpose")
        self.kernel_size, self.stride = kernel_size, stride
        self.causal, self.trim_right_ratio = causal, trim_right_ratio
        self.convtr = NormConvTranspose1d(
            in_channels, out_channels, kernel_size, stride=stride, bias=bias, norm=norm
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding_total = self.kernel_size - self.stride
        if self.causal:
            pad_right = math.ceil(padding_total * self.trim_right_ratio)
        else:
            pad_right = padding_total // 2
        return unpad1d(self.convtr(x), (padding_total - pad_right, pad_right))
