"""SLSTM: the SEANet bottleneck, a 2-layer LSTM with a skip connection, on ``[B, C, T]``.

The layer-1 input projection ``x @ W_ih1^T + b1`` is one large matmul over
all timesteps; the recurrence of both layers is ``ops/cuda/lstm.lstm2``,
which runs the fused kernel for CUDA tensors (no cuDNN LSTM on the path)
and its plain version for CPU tensors. The weights' dtype selects the
numerics: bf16 models get the serving kernel's bf16 products, f32 models
the f32 scan path's.

Parameters are registered under the names of ``torch.nn.LSTM``
(``lstm.weight_ih_l0`` ...), so reference checkpoints load as they are.

Streaming: ``forward(x, carry=..., return_carry=True)`` continues a stream
from ``carry = ((h1, c1), (h2, c2))`` (JAX's per-layer layout, from
:meth:`SLSTM.init_carry`) and gives back the final state. The carry goes
through ``lstm2`` too, so on the card it runs in the kernel. It is f32
whatever the model's dtype (the JAX scan path carries the model's dtype).

Behavioral parity target: academicodec_tpu/nn/lstm.py:116-149.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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

    def init_carry(self, batch: int):
        """The zero state ``((h1, c1), (h2, c2))``, f32 ``[batch, H]`` on the module's device."""
        w = self.lstm.weight_hh_l0
        z = torch.zeros((batch, w.shape[1]), dtype=torch.float32, device=w.device)
        return ((z, z), (z, z))

    def forward(self, x: torch.Tensor, carry: Optional[tuple] = None, return_carry: bool = False):
        """``x [B, C, T]`` -> ``y [B, C, T]``; with ``return_carry``, ``(y, final carry)``."""
        flat = None if carry is None else (*carry[0], *carry[1])
        out = lstm2(*self.recurrence_inputs(x), out_dtype=x.dtype, carry=flat, return_carry=return_carry)
        y, final = out if return_carry else (out, None)
        y = y.permute(1, 2, 0)
        y = y + x if self.skip else y
        return (y, (final[:2], final[2:])) if return_carry else y

    def stream(self, x: torch.Tensor, carry=None):
        """One chunk of a stream: ``(y, next carry)``; ``carry`` None starts one."""
        return self.forward(x, carry, return_carry=True)
