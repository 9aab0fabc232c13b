"""Residual vector quantizers: bandwidth-driven (SoundStream / Encodec) and split (Mimi).

:class:`ResidualVectorQuantizer`'s behavioral parity target:
academicodec_tpu/quant/vq.py:58-96 (the
``n_q = floor(bandwidth / (log2(bins) * frame_rate / 1000))`` selection,
clamped to the codebook count, and the training forward's
``(quantized, codes, bandwidth, mean commit loss)``).

:class:`SplitResidualVectorQuantizer` is Mimi's (moshi
quantization/vq.py ``SplitResidualVectorQuantizer``): a first part of
``n_q_semantic`` codebooks and a rest of ``n_q - n_q_semantic``, each with
its own bias-free 1x1 projections into and out of the codebooks' dimension,
both quantizing the same latent; decoding sums the two parts' outputs. Each
part's search is one K1 call (``quant/core_vq.py``). Serving only.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from academicodec_tpu_torch.nn.conv import Conv1d
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
        group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, float, torch.Tensor]:
        """Training/eval forward on ``[B, T, D]`` with ``n_q`` layers (from
        ``bandwidth`` when None) -> ``(quantized, codes [n_q, B, T], kb/s, commit
        loss)``; the commit loss is the mean over the active layers. ``group``: the
        data-parallel process group (``ResidualVQ.forward``)."""
        if n_q is None:
            n_q = self.get_num_quantizers_for_bandwidth(frame_rate, bandwidth)
        quantized, codes, losses = self.vq(x, n_q=n_q, training=training, draws=draws, group=group)
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


class ProjectedResidualVQ(nn.Module):
    """``input_proj`` (``dimension -> codebook_dim``), a residual VQ of ``n_q`` codebooks,
    ``output_proj`` back; both projections 1x1 convs without bias, on ``[B, C, T]``."""

    def __init__(self, dimension: int, codebook_dim: int, n_q: int, bins: int):
        super().__init__()
        self.n_q = n_q
        self.input_proj = Conv1d(dimension, codebook_dim, 1, bias=False)
        self.output_proj = Conv1d(codebook_dim, dimension, 1, bias=False)
        self.vq = ResidualVQ(num_quantizers=n_q, dim=codebook_dim, codebook_size=bins)

    def encode(self, x: torch.Tensor, n_q: int) -> torch.Tensor:
        """``x [B, dimension, T]`` -> codes ``[n_q, B, T]`` int32."""
        return self.vq.encode(self.input_proj(x).transpose(1, 2), n_q=n_q)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, B, T]`` -> ``[B, dimension, T]``."""
        return self.output_proj(self.vq.decode(codes).transpose(1, 2))


class SplitResidualVectorQuantizer(nn.Module):
    """Mimi's split RVQ (module docstring): codes ``[n_q, B, T]``, the first part's first."""

    def __init__(self, dimension: int = 512, codebook_dim: int = 256, n_q: int = 32, n_q_semantic: int = 1,
                 bins: int = 2048):
        super().__init__()
        if not 1 <= n_q_semantic < n_q:
            raise ValueError(f"n_q_semantic {n_q_semantic} outside 1..{n_q - 1}")
        self.n_q, self.n_q_semantic, self.bins = n_q, n_q_semantic, bins
        self.rvq_first = ProjectedResidualVQ(dimension, codebook_dim, n_q_semantic, bins)
        self.rvq_rest = ProjectedResidualVQ(dimension, codebook_dim, n_q - n_q_semantic, bins)

    def encode(self, x: torch.Tensor, n_q: Optional[int] = None) -> torch.Tensor:
        """``x [B, dimension, T]`` -> codes ``[n_q, B, T]`` int32 (all codebooks for None)."""
        n_q = self.n_q if n_q is None else int(n_q)
        if not 1 <= n_q <= self.n_q:
            raise ValueError(f"n_q {n_q} outside 1..{self.n_q}")
        first = self.rvq_first.encode(x, min(n_q, self.n_q_semantic))
        if n_q <= self.n_q_semantic:
            return first
        return torch.cat([first, self.rvq_rest.encode(x, n_q - self.n_q_semantic)])

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, B, T]`` -> ``[B, dimension, T]``: the parts' outputs summed."""
        k = self.n_q_semantic
        out = self.rvq_first.decode(codes[:k])
        return out if codes.shape[0] <= k else out + self.rvq_rest.decode(codes[k:])
