"""1D padding math for strided convolutions on ``[..., T]`` (time last).

The port's copy of ``academicodec_tpu/ops/padding.py`` for the PyTorch
``[B, C, T]`` layout: the encoder right-pads so the final conv window is
full, causal mode puts all fixed padding on the left, and inputs shorter
than a reflect pad get a zero-pad guard first (reference semantics:
academicodec/modules/conv.py:58-121).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def get_extra_padding_for_conv1d(
    length: int, kernel_size: int, stride: int, padding_total: int = 0
) -> int:
    """Extra right padding so the last conv window is full (ceil framing)."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def pad1d(
    x: torch.Tensor, paddings: Tuple[int, int], mode: str = "zero", value: float = 0.0
) -> torch.Tensor:
    """Pad the time axis (-1).

    With ``mode='reflect'`` and a signal no longer than the largest pad, the
    signal is zero-extended on the right first so the reflection is defined,
    and the extension is cut off again afterwards.
    """
    pad_left, pad_right = paddings
    if pad_left < 0 or pad_right < 0:
        raise ValueError(f"negative padding {paddings}")
    if mode in ("zero", "constant"):
        return F.pad(x, (pad_left, pad_right), value=value)
    if mode != "reflect":
        return F.pad(x, (pad_left, pad_right), mode=mode)
    length = x.shape[-1]
    max_pad = max(pad_left, pad_right)
    extra_pad = 0
    if length <= max_pad:
        extra_pad = max_pad - length + 1
        x = F.pad(x, (0, extra_pad))
    padded = F.pad(x, (pad_left, pad_right), mode="reflect")
    return padded[..., : padded.shape[-1] - extra_pad]


def unpad1d(x: torch.Tensor, paddings: Tuple[int, int]) -> torch.Tensor:
    """Remove padding from the time axis (-1)."""
    pad_left, pad_right = paddings
    if pad_left < 0 or pad_right < 0 or pad_left + pad_right > x.shape[-1]:
        raise ValueError(f"bad unpadding {paddings} for length {x.shape[-1]}")
    return x[..., pad_left : x.shape[-1] - pad_right]
