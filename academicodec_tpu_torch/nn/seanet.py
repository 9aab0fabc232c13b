"""SEANet encoder and decoder on ``[B, C, T]``.

Each tower is one ``nn.Sequential`` in which every activation takes a
slot, exactly like the reference, so state-dict keys read
``encoder.model.N...`` with the same ``N`` as the JAX package's
``model_{N}`` submodules. ELU activations only; no final activation.

Causal towers stream: ``stream(x, state)`` takes one chunk and the state
the last chunk left (None starts a stream) and returns ``(y, next state)``:
one entry per layer, the carried inputs of each conv, the overlap-add tail
of each conv-transpose and the SLSTM's (h, c), as JAX's ``cache`` holds
them (academicodec_tpu/nn/seanet.py:133-236, 274-319).

Behavioral parity target: academicodec_tpu/nn/seanet.py:39-384.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from academicodec_tpu_torch.nn.conv import SConv1d, SConvTranspose1d, stream_layers
from academicodec_tpu_torch.nn.lstm import SLSTM


class SEANetResnetBlock(nn.Module):
    """``[ELU -> SConv1d(k, dilation) -> ELU -> SConv1d(1)] + shortcut``."""

    def __init__(
        self,
        dim: int,
        kernel_sizes: Sequence[int] = (3, 1),
        dilations: Sequence[int] = (1, 1),
        norm: str = "weight_norm",
        causal: bool = False,
        pad_mode: str = "reflect",
        compress: int = 2,
        true_skip: bool = True,
    ):
        super().__init__()
        hidden = dim // compress
        n = len(kernel_sizes)
        block = []
        for i, (k, d) in enumerate(zip(kernel_sizes, dilations)):
            block += [
                nn.ELU(),
                SConv1d(
                    dim if i == 0 else hidden, dim if i == n - 1 else hidden, k,
                    dilation=d, norm=norm, causal=causal, pad_mode=pad_mode,
                ),
            ]
        self.block = nn.Sequential(*block)
        self.shortcut = (
            nn.Identity()
            if true_skip
            else SConv1d(dim, dim, 1, norm=norm, causal=causal, pad_mode=pad_mode)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)

    def stream(self, x: torch.Tensor, state=None):
        block_state, short_state = state if state is not None else (None, None)
        y, block_state = stream_layers(self.block, x, block_state)
        short, short_state = stream_layers([self.shortcut], x, short_state)
        return short + y, (block_state, short_state)


class SEANetEncoder(nn.Module):
    """Conv stem -> per ratio [resblocks -> ELU -> strided conv] -> SLSTM -> ELU -> proj.

    ``ratios`` are given in decoder order and reversed here, as in the reference.
    """

    def __init__(
        self,
        channels: int = 1,
        dimension: int = 128,
        n_filters: int = 32,
        n_residual_layers: int = 1,
        ratios: Tuple[int, ...] = (8, 5, 4, 2),
        norm: str = "weight_norm",
        kernel_size: int = 7,
        last_kernel_size: int = 7,
        residual_kernel_size: int = 3,
        dilation_base: int = 2,
        causal: bool = False,
        pad_mode: str = "reflect",
        true_skip: bool = False,
        compress: int = 2,
        lstm: int = 2,
    ):
        super().__init__()
        common = dict(norm=norm, causal=causal, pad_mode=pad_mode)
        mult = 1
        layers = [SConv1d(channels, n_filters, kernel_size, **common)]
        for ratio in reversed(ratios):
            for j in range(n_residual_layers):
                layers.append(
                    SEANetResnetBlock(
                        mult * n_filters, (residual_kernel_size, 1), (dilation_base**j, 1),
                        compress=compress, true_skip=true_skip, **common,
                    )
                )
            layers += [
                nn.ELU(),
                SConv1d(mult * n_filters, 2 * mult * n_filters, 2 * ratio, stride=ratio, **common),
            ]
            mult *= 2
        if lstm:
            layers.append(SLSTM(mult * n_filters, num_layers=lstm))
        layers += [nn.ELU(), SConv1d(mult * n_filters, dimension, last_kernel_size, **common)]
        self.model = nn.Sequential(*layers)
        self.causal = causal
        self.hop_length = math.prod(ratios)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def stream(self, x: torch.Tensor, state=None):
        """One chunk ``[B, C, Tc]``, ``Tc`` a multiple of the hop length."""
        if not self.causal:
            raise ValueError("streaming encode needs a causal model")
        if x.shape[-1] % self.hop_length:
            raise ValueError(f"stream chunks must be a multiple of the hop length {self.hop_length}")
        return stream_layers(self.model, x, state)


class SEANetDecoder(nn.Module):
    """Proj -> SLSTM -> per ratio [ELU -> convT -> resblocks] -> ELU -> conv to audio."""

    def __init__(
        self,
        channels: int = 1,
        dimension: int = 128,
        n_filters: int = 32,
        n_residual_layers: int = 1,
        ratios: Tuple[int, ...] = (8, 5, 4, 2),
        norm: str = "weight_norm",
        kernel_size: int = 7,
        last_kernel_size: int = 7,
        residual_kernel_size: int = 3,
        dilation_base: int = 2,
        causal: bool = False,
        pad_mode: str = "reflect",
        true_skip: bool = False,
        compress: int = 2,
        lstm: int = 2,
        trim_right_ratio: float = 1.0,
    ):
        super().__init__()
        common = dict(norm=norm, causal=causal, pad_mode=pad_mode)
        mult = 2 ** len(ratios)
        layers = [SConv1d(dimension, mult * n_filters, kernel_size, **common)]
        if lstm:
            layers.append(SLSTM(mult * n_filters, num_layers=lstm))
        for ratio in ratios:
            layers += [
                nn.ELU(),
                SConvTranspose1d(
                    mult * n_filters, mult * n_filters // 2, 2 * ratio, stride=ratio,
                    norm=norm, causal=causal, trim_right_ratio=trim_right_ratio,
                ),
            ]
            for j in range(n_residual_layers):
                layers.append(
                    SEANetResnetBlock(
                        mult * n_filters // 2, (residual_kernel_size, 1), (dilation_base**j, 1),
                        compress=compress, true_skip=true_skip, **common,
                    )
                )
            mult //= 2
        layers += [nn.ELU(), SConv1d(n_filters, channels, last_kernel_size, **common)]
        self.model = nn.Sequential(*layers)
        self.causal = causal

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z)

    def stream(self, z: torch.Tensor, state=None):
        if not self.causal:
            raise ValueError("streaming decode needs a causal model")
        return stream_layers(self.model, z, state)
