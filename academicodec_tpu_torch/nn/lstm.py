"""SLSTM: the SEANet bottleneck, a 2-layer LSTM with a skip connection, on ``[B, C, T]``.

The layer-1 input projection ``x @ W_ih1^T + b1`` is one large matmul over
all timesteps; the recurrence of both layers is ``ops/cuda/lstm.lstm2``,
which runs the fused kernel for CUDA tensors (no cuDNN LSTM on the path)
and its plain version for CPU tensors. The weights' dtype selects the
numerics: bf16 models get the serving kernel's bf16 products, f32 models
the f32 scan path's.

Parameters are registered under the names of ``torch.nn.LSTM``
(``lstm.weight_ih_l0`` ...), so reference checkpoints load as they are.
The streaming carry path comes with the streaming port.

Behavioral parity target: academicodec_tpu/nn/lstm.py:116-149.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from academicodec_tpu_torch.ops.cuda.lstm import lstm2

_NAMES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


class LSTMParams(nn.Module):
    """The parameters of a ``torch.nn.LSTM`` (hidden == input size), without its cuDNN call."""

    def __init__(self, dimension: int, num_layers: int = 2):
        super().__init__()
        self.dimension, self.num_layers = dimension, num_layers
        h4 = 4 * dimension
        for layer in range(num_layers):
            self.register_parameter(f"weight_ih_l{layer}", nn.Parameter(torch.empty(h4, dimension)))
            self.register_parameter(f"weight_hh_l{layer}", nn.Parameter(torch.empty(h4, dimension)))
            self.register_parameter(f"bias_ih_l{layer}", nn.Parameter(torch.empty(h4)))
            self.register_parameter(f"bias_hh_l{layer}", nn.Parameter(torch.empty(h4)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.dimension)
        with torch.no_grad():
            for layer in range(self.num_layers):
                for name in _NAMES:
                    p = getattr(self, f"{name}_l{layer}")
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"{name}_l{i}") for name in _NAMES)


class SLSTM(nn.Module):
    """Two stacked LSTM layers over ``[B, C, T]`` plus the skip ``y + x``."""

    def __init__(self, dimension: int, num_layers: int = 2, skip: bool = True):
        super().__init__()
        if num_layers != 2:
            raise ValueError("the port's SLSTM runs the fused 2-layer recurrence only")
        self.skip = skip
        self.lstm = LSTMParams(dimension, num_layers)

    def recurrence_inputs(self, x: torch.Tensor):
        """``x [B, C, T]`` -> the arguments of ``lstm2``: ``(x_proj [T, B, 4H] f32,
        W_hh1, W_ih2, W_hh2, b2 f32)``."""
        w_ih1, w_hh1, b_ih1, b_hh1 = self.lstm.layer(0)
        w_ih2, w_hh2, b_ih2, b_hh2 = self.lstm.layer(1)
        x_proj = torch.matmul(x.permute(2, 0, 1), w_ih1.t()).float() + (b_ih1 + b_hh1).float()
        return x_proj, w_hh1, w_ih2, w_hh2, (b_ih2 + b_hh2).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = lstm2(*self.recurrence_inputs(x), out_dtype=x.dtype).permute(1, 2, 0)
        return y + x if self.skip else y
