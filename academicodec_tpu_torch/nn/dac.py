"""The Descript Audio Codec's towers: Snake-activated residual units, encoder and decoder blocks.

Equations and structure as dac/model/dac.py and dac/nn/layers.py
(descript-audio-codec): every conv weight-normed with a bias and zero
padding on both sides (``nn/conv.py``'s ``Conv1d`` / ``ConvTranspose1d``,
``norm="weight_norm"``); ``Snake1d(C)``: ``y = x + (alpha + 1e-9)^-1 *
sin(alpha x)^2`` with a learnt ``alpha [1, C, 1]``;
``ResidualUnit(C, d)``: ``x + conv_1x1(Snake(conv_k7_dil_d(Snake(x))))`` (the
conv pads ``3 d`` each side, so lengths match and DAC's centre crop does
nothing); ``EncoderBlock(2C, s)``: three residual units at dilations 1, 3, 9,
a Snake and a ``C -> 2C`` conv of kernel ``2 s``, stride ``s``, padding
``ceil(s / 2)``; ``DecoderBlock(C_in, C_out, s)``: a Snake, a ``C_in ->
C_out`` conv-transpose of the same kernel, stride and padding (DAC's
``output_padding`` is ``s % 2``, 0 for the even strides served here), and
three residual units. Modules and state-dict keys are DAC's own
(``block.N`` / ``model.N``, ``alpha``, ``weight_v`` / ``weight_g`` /
``bias``), so a DAC checkpoint's tower keys load as they are.

**How the towers run.** Every conv but the encoder's last and the decoder's
``conv_out`` runs without its bias; everything from such a conv to the next
conv is one call of ``ops/cuda/snake.py`` (one kernel launch on the card):
the bias, the residual unit's sum where one ends, and the Snake, in f32. The
sum is written too where a later residual add reads it (:class:`Pending`
carries a conv's bias-free output, its bias and the residual still to add).
A roundtrip runs 29 such epilogues in the encoder and 29 in the decoder. Each
is one ``codec.snake`` span (``utils/profiling.py``) and adds the elements it
activates to the counter ``snake.elements``, from host shapes. Under autograd
the epilogues run the plain version.

In 16-bit on the card the towers run channels-last ``[B, C, 1, T]`` from the
encoder's first conv to its last and from the decoder's first conv to
``conv_out`` (``nn/conv.py``'s 4-D route): the epilogue in front of a
dilated conv writes its output ``ceil(T / d) * d`` frames long, the tail
zeros, so that the conv runs as its phases with no pad, and the next
epilogue reads the conv's first ``T`` frames as a strided view, so that
nothing crops; the decoder's one-channel ``conv_out`` runs with its kernel
padded to 8 output channels (:func:`narrow_conv`). Elsewhere (f32, the CPU)
they run ``[B, C, T]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d, channels_last_kernel
from academicodec_tpu_torch.ops.cuda import snake as snake_ops
from academicodec_tpu_torch.utils import profiling

DILATIONS = (1, 3, 9)  # of each block's three residual units
RESIDUAL_KERNEL = 7
OUT_CHANNEL_TILE = 8  # output channels of the NHWC tensor-core convs cuDNN picks


def channels_last_towers(x: torch.Tensor) -> bool:
    """Whether the towers over ``x`` run channels-last: on the card in a 16-bit dtype."""
    return x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)


def wav_channels_last(x: torch.Tensor) -> torch.Tensor:
    """wav ``[B, T]`` as ``[B, 1, 1, T]`` with the strides ``(T, 1, T, 1)``: one channel is
    both layouts, and torch reads these strides (not the view's ``(T, T, T, 1)``) as
    channels-last, so that cuDNN writes the first conv's output channels-last."""
    B, T = x.shape
    return x.contiguous().as_strided((B, 1, 1, T), (T, 1, T, 1))


def conv(cin: int, cout: int, kernel_size: int, stride: int = 1, dilation: int = 1, padding: int = 0) -> Conv1d:
    return Conv1d(cin, cout, kernel_size, stride=stride, dilation=dilation, padding=padding, norm="weight_norm")


def narrow_conv(layer: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (stride 1, undilated) over channels-last ``x [B, C, 1, T]``, its kernel
    and bias given zero output channels up to :data:`OUT_CHANNEL_TILE`, the real ones
    kept as a view: for the decoder's one-channel ``conv_out`` over ``[16, 96, 1,
    441344]`` cuDNN's NHWC route otherwise picks a generic CUDA-core kernel: 19.6 ms
    against 2.4 ms padded on the H100."""
    profiling.count("towers.cl_convs")
    w = layer.resolved_weight()
    pad = -w.shape[0] % OUT_CHANNEL_TILE
    bias = F.pad(layer.bias, (0, pad))
    y = F.conv2d(x, channels_last_kernel(F.pad(w, (0, 0, 0, 0, 0, pad))), bias, padding=(0, layer.padding))
    return y[:, : w.shape[0]]


class Pending(NamedTuple):
    """A conv's output without its bias, the bias, and the residual still to add."""
    h: torch.Tensor
    bias: Optional[torch.Tensor]
    residual: Optional[torch.Tensor] = None


def biasless(layer: nn.Module, x: torch.Tensor) -> Pending:
    return Pending(layer(x, add_bias=False), layer.bias)


class Snake1d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """DAC's ``Snake1d`` on ``x`` alone."""
        return self.epilogue(Pending(x, None))[0]

    def epilogue(self, p: Pending, keep_sum: bool = False,
                 frames: Optional[int] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``Snake(h + bias (+ residual))`` -> ``(y, the sum or None)``; ``frames``: ``y``'s
        frames (channels-last), zero past ``h``'s."""
        profiling.count("snake.elements", p.h.numel())
        records = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (p.h, self.alpha, p.bias, p.residual))
        fn = snake_ops.snake_plain if records else snake_ops.snake
        with profiling.span("codec.snake"):
            return fn(p.h, self.alpha, p.bias, p.residual, keep_sum, frames)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        pad = (RESIDUAL_KERNEL - 1) * dilation // 2
        self.block = nn.Sequential(Snake1d(dim), conv(dim, dim, RESIDUAL_KERNEL, dilation=dilation, padding=pad),
                                   Snake1d(dim), conv(dim, dim, 1))

    def run(self, p: Pending) -> Pending:
        """The unit over its input still pending -> its output, pending (the 1x1 conv's
        bias and the input to add)."""
        snake1, dilated, snake2, pointwise = self.block
        T = p.h.shape[-1]
        d = dilated.dilation
        y, x = snake1.epilogue(p, keep_sum=True, frames=-(-T // d) * d if p.h.dim() == 4 else None)
        t = dilated(y, add_bias=False)[..., :T]
        y, _ = snake2.epilogue(Pending(t, dilated.bias))
        return Pending(pointwise(y, add_bias=False), pointwise.bias, x)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        c = dim // 2
        self.block = nn.Sequential(*(ResidualUnit(c, d) for d in DILATIONS), Snake1d(c),
                                   conv(c, dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2)))

    def run(self, p: Pending) -> Pending:
        for unit in self.block[:3]:
            p = unit.run(p)
        y, _ = self.block[3].epilogue(p)
        return biasless(self.block[4], y)


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int):
        super().__init__()
        self.block = nn.Sequential(
            Snake1d(input_dim),
            ConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2),
                            norm="weight_norm"),
            *(ResidualUnit(output_dim, d) for d in DILATIONS),
        )

    def run(self, p: Pending) -> Pending:
        y, _ = self.block[0].epilogue(p)
        p = biasless(self.block[1], y)
        for unit in self.block[2:]:
            p = unit.run(p)
        return p


class Encoder(nn.Module):
    """wav ``[B, 1, T]`` (channels-last ``[B, 1, 1, T]``) -> latent ``[B, d_latent, T / prod(strides)]``."""

    def __init__(self, d_model: int = 64, strides: Sequence[int] = (2, 4, 8, 8), d_latent: int = 1024):
        super().__init__()
        layers = [conv(1, d_model, 7, padding=3)]
        for stride in strides:
            d_model *= 2
            layers.append(EncoderBlock(d_model, stride))
        layers += [Snake1d(d_model), conv(d_model, d_latent, 3, padding=1)]
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = biasless(self.block[0], x)
        for blk in self.block[1:-2]:
            p = blk.run(p)
        y, _ = self.block[-2].epilogue(p)
        return self.block[-1](y)


class Decoder(nn.Module):
    """latent ``[B, input_channel, frames]`` (channels-last ``[B, C, 1, frames]``) ->
    wav ``[B, 1, frames x prod(rates)]`` in [-1, 1]."""

    def __init__(self, input_channel: int = 1024, channels: int = 1536, rates: Sequence[int] = (8, 8, 4, 2),
                 d_out: int = 1):
        super().__init__()
        layers = [conv(input_channel, channels, 7, padding=3)]
        for i, stride in enumerate(rates):
            layers.append(DecoderBlock(channels // 2 ** i, channels // 2 ** (i + 1), stride))
        output_dim = channels // 2 ** len(rates)
        layers += [Snake1d(output_dim), conv(output_dim, d_out, 7, padding=3), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = biasless(self.model[0], x)
        for blk in self.model[1:-3]:
            p = blk.run(p)
        y, _ = self.model[-3].epilogue(p)
        conv_out = self.model[-2]
        return self.model[-1](narrow_conv(conv_out, y) if y.dim() == 4 else conv_out(y))


def epilogue_convs(module: nn.Module):
    """The convs of ``module``'s towers whose bias an epilogue adds: all but the
    encoder's last and the decoder's ``conv_out``."""
    for tower in (m for m in module.modules() if isinstance(m, (Encoder, Decoder))):
        layers = tower.block if isinstance(tower, Encoder) else tower.model
        last = layers[-1] if isinstance(tower, Encoder) else layers[-2]
        for m in tower.modules():
            if isinstance(m, (Conv1d, ConvTranspose1d)) and m is not last:
                yield m
