"""Bandwidth-driven residual vector quantizer.

Behavioral parity target: academicodec_tpu/quant/vq.py:58-96 (the
``n_q = floor(bandwidth / (log2(bins) * frame_rate / 1000))`` selection,
clamped to the codebook count, and the training forward's
``(quantized, codes, bandwidth, mean commit loss)``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from academicodec_tpu_torch.quant.core_vq import ResidualVQ


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dimension: int = 256, n_q: int = 8, bins: int = 1024):
        super().__init__()
        self.n_q, self.bins = n_q, bins
        self.vq = ResidualVQ(num_quantizers=n_q, dim=dimension, codebook_size=bins)

    def get_bandwidth_per_quantizer(self, frame_rate: int) -> float:
        return math.log2(self.bins) * frame_rate / 1000

    def get_num_quantizers_for_bandwidth(
        self, frame_rate: int, bandwidth: Optional[float] = None
    ) -> int:
        n_q = self.n_q
        if bandwidth and bandwidth > 0.0:
            # the stack holds n_q layers, so encode never emits more streams
            bw_per_q = self.get_bandwidth_per_quantizer(frame_rate)
            n_q = int(min(self.n_q, max(1, math.floor(bandwidth / bw_per_q))))
        return n_q

    def forward(
        self,
        x: torch.Tensor,
        frame_rate: int,
        bandwidth: Optional[float] = None,
        n_q: Optional[int] = None,
        training: bool = False,
        draws: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, float, torch.Tensor]:
        """Training/eval forward on ``[B, T, D]`` with ``n_q`` layers (from
        ``bandwidth`` when None) -> ``(quantized, codes [n_q, B, T], kb/s, commit
        loss)``; the commit loss is the mean over the active layers."""
        if n_q is None:
            n_q = self.get_num_quantizers_for_bandwidth(frame_rate, bandwidth)
        quantized, codes, losses = self.vq(x, n_q=n_q, training=training, draws=draws)
        bw = n_q * self.get_bandwidth_per_quantizer(frame_rate)
        return quantized, codes, bw, losses.sum() / max(n_q, 1)

    def encode(
        self, x: torch.Tensor, frame_rate: int, bandwidth: Optional[float] = None, st: int = 0
    ) -> torch.Tensor:
        """``[B, T, D]`` -> codes ``[n_q - st, B, T]``."""
        n_q = self.get_num_quantizers_for_bandwidth(frame_rate, bandwidth)
        return self.vq.encode(x, n_q=n_q, st=st)

    def decode(self, codes: torch.Tensor, st: int = 0) -> torch.Tensor:
        """codes ``[n, B, T]`` -> ``[B, T, D]``."""
        return self.vq.decode(codes, st=st)
