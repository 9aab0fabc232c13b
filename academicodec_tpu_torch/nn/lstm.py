"""SLSTM: the SEANet bottleneck, stacked LSTM layers with a skip connection, on ``[B, C, T]``.

Two layers (every reference config) take the fused kernel. The layer-1
input projection ``x @ W_ih1^T + b1`` is one large matmul over all
timesteps; the recurrence of both layers is ``ops/cuda/lstm.lstm2``,
which runs the fused kernel for CUDA tensors (no cuDNN LSTM on the path)
and its plain version for CPU tensors. The weights' dtype selects the
numerics: bf16 models get the serving kernel's bf16 products, f32 models
the f32 scan path's.

Parameters are registered under the names of ``torch.nn.LSTM``
(``lstm.weight_ih_l0`` ...), so reference checkpoints load as they are.

Any other layer count runs a library LSTM, as JAX runs its scan there
(the Pallas kernel is 2-layer only): for CUDA tensors cuDNN's, through
``torch._VF.lstm`` on the same parameters, and for CPU tensors the plain
step loop of :func:`lstm_layers_plain`, which is the JAX scan's.

Streaming: ``forward(x, carry=..., return_carry=True)`` continues a stream
from ``carry = ((h1, c1), (h2, c2), ...)``, one pair per layer (JAX's
layout, from :meth:`SLSTM.init_carry`) and gives back the final state. At 2
layers the carry goes through ``lstm2`` too, so on the card it runs in the
kernel. It is f32 whatever the model's dtype (the JAX scan path carries
the model's dtype; cuDNN takes it in the input's dtype).

Behavioral parity target: academicodec_tpu/nn/lstm.py:37-149.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from academicodec_tpu_torch.ops.cuda.lstm import _lstm_cell, lstm2

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


LayerCarry = Tuple[torch.Tensor, torch.Tensor]


def lstm_layers_plain(x: torch.Tensor, layers: Sequence[Tuple[torch.Tensor, ...]],
                      carry: Sequence[LayerCarry]):
    """Stacked LSTM layers over ``x [T, B, C]`` step by step, as the JAX scan
    computes them (nn/lstm.py:58-85): each layer's input projection over all
    steps first, then ``gates = x_proj[t] + h @ W_hh^T``. ``layers``: each
    layer's ``(W_ih, W_hh, b_ih, b_hh)``; ``carry``: each layer's ``(h, c)``.
    Returns ``(y [T, B, H], final carry)``."""
    finals = []
    y = x
    for (w_ih, w_hh, b_ih, b_hh), (h, c) in zip(layers, carry):
        x_proj = torch.matmul(y, w_ih.t()) + b_ih + b_hh
        h, c = h.to(x_proj.dtype), c.to(x_proj.dtype)
        ys = []
        for t in range(x_proj.shape[0]):
            h, c = _lstm_cell(x_proj[t] + torch.matmul(h, w_hh.t()), c)
            ys.append(h)
        y = torch.stack(ys) if ys else x_proj[..., : w_hh.shape[1]]
        finals.append((h, c))
    return y, finals


def lstm_layers(x: torch.Tensor, layers: Sequence[Tuple[torch.Tensor, ...]], carry: Sequence[LayerCarry]):
    """:func:`lstm_layers_plain`'s function: cuDNN's LSTM for CUDA tensors, the
    plain loop for CPU tensors. The carry goes in and comes out f32."""
    if x.device.type == "cpu":
        y, finals = lstm_layers_plain(x, layers, carry)
    elif x.device.type == "cuda":
        flat = [w for layer in layers for w in layer]
        h0 = torch.stack([h for h, _ in carry]).to(x.dtype)
        c0 = torch.stack([c for _, c in carry]).to(x.dtype)
        with warnings.catch_warnings():  # the weights are separate tensors, not one cuDNN buffer
            warnings.filterwarnings("ignore", message="RNN module weights are not part of single contiguous")
            y, h_n, c_n = torch._VF.lstm(x, (h0, c0), flat, True, len(layers), 0.0, False, False, False)
        finals = list(zip(h_n.unbind(0), c_n.unbind(0)))
    else:
        raise ValueError(f"lstm_layers: no LSTM for {x.device}")
    return y, [(h.float(), c.float()) for h, c in finals]


class SLSTM(nn.Module):
    """Stacked LSTM layers over ``[B, C, T]`` plus the skip ``y + x``."""

    def __init__(self, dimension: int, num_layers: int = 2, skip: bool = True):
        super().__init__()
        if num_layers < 1:
            raise ValueError(f"an SLSTM has at least one layer, got {num_layers}")
        self.skip, self.num_layers = skip, num_layers
        self.lstm = LSTMParams(dimension, num_layers)

    def recurrence_inputs(self, x: torch.Tensor):
        """``x [B, C, T]`` -> the arguments of ``lstm2``: ``(x_proj [T, B, 4H] f32,
        W_hh1, W_ih2, W_hh2, b2 f32)``."""
        w_ih1, w_hh1, b_ih1, b_hh1 = self.lstm.layer(0)
        w_ih2, w_hh2, b_ih2, b_hh2 = self.lstm.layer(1)
        x_proj = torch.matmul(x.permute(2, 0, 1), w_ih1.t()).float() + (b_ih1 + b_hh1).float()
        return x_proj, w_hh1, w_ih2, w_hh2, (b_ih2 + b_hh2).float()

    def init_carry(self, batch: int):
        """The zero state, one ``(h, c)`` per layer, f32 ``[batch, H]`` on the module's device."""
        w = self.lstm.weight_hh_l0
        z = torch.zeros((batch, w.shape[1]), dtype=torch.float32, device=w.device)
        return tuple((z, z) for _ in range(self.num_layers))

    def forward(self, x: torch.Tensor, carry: Optional[tuple] = None, return_carry: bool = False):
        """``x [B, C, T]`` -> ``y [B, C, T]``; with ``return_carry``, ``(y, final carry)``."""
        if self.num_layers == 2:
            flat = None if carry is None else (*carry[0], *carry[1])
            out = lstm2(*self.recurrence_inputs(x), out_dtype=x.dtype, carry=flat, return_carry=return_carry)
            y, final = out if return_carry else (out, None)
            final = None if final is None else (final[:2], final[2:])
        else:
            layers = [self.lstm.layer(i) for i in range(self.num_layers)]
            y, final = lstm_layers(x.permute(2, 0, 1), layers, carry or self.init_carry(x.shape[0]))
            final = tuple(final)
        y = y.permute(1, 2, 0)
        y = y + x if self.skip else y
        return (y, final) if return_carry else y

    def stream(self, x: torch.Tensor, carry=None):
        """One chunk of a stream: ``(y, next carry)``; ``carry`` None starts one."""
        return self.forward(x, carry, return_carry=True)
