"""Post-conv activation norms on ``[B, C, T]``: the conv layers' ``layer_norm``
and ``time_group_norm`` modes.

``ConvLayerNorm`` normalizes over the channels at each time step, so it
streams; ``TimeGroupNorm`` is torch ``GroupNorm(1, C)``, statistics over
(C, T) of each item, which span the whole utterance and do not stream.
Both keep ``weight`` / ``bias`` as the reference modules do, and eps 1e-5.
The reference's ``ConvLayerNorm`` returns None; this one returns the
normalized tensor, as the JAX package's does.

Behavioral parity target: academicodec_tpu/nn/norm.py:19-48 (reference
academicodec/modules/norm.py, conv.py:38-55).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class ConvLayerNorm(nn.Module):
    """LayerNorm over the channel axis of ``[B, C, T]``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Statistics and normalization in f32, as flax's LayerNorm computes
        them, reduced over dim 1 in place: no transposes to ``[B, T, C]``."""
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=1, keepdim=True, correction=0)
        y = torch.addcmul(self.bias.float()[:, None], (xf - mean) * torch.rsqrt(var + self.eps),
                          self.weight.float()[:, None])
        return y.to(x.dtype)


class TimeGroupNorm(nn.Module):
    """torch ``GroupNorm(1, C)``: one mean and variance over (C, T) per item.
    The statistics are one grid-wide reduction each (``var_mean``), not
    ``F.group_norm``, whose CUDA kernel gives each (item, group) one block:
    a batch of 8 would use 8 of the card's SMs."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(1, 2), keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight[:, None] + self.bias[:, None]


POST_NORMS = {"layer_norm": ConvLayerNorm, "time_group_norm": TimeGroupNorm}
