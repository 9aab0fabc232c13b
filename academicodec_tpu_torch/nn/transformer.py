"""Chunk-streamable transformer encoder: the trunk of the token LM.

Sinusoidal positions from a running ``offset``, post-norm layers (torch's
default) whose self-attention also sees each layer's past inputs, and the
band mask ``0 <= q_pos - k_pos <= past_context``. The past is a fixed-size
rolling buffer per layer, ``[B, past_context, C]``, zeros at the start of a
stream, so every step of a stream has the same shapes; the offset (a tensor
or an int) masks the buffer's slots before the stream's start. Attention
keeps torch ``MultiheadAttention``'s packed ``in_proj`` layout.

Plain PyTorch ops: the JAX package has no Pallas kernel here.

Behavioral parity target: academicodec_tpu/nn/transformer.py:26-211
(reference academicodec/modules/transformer.py:14-141).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Offset = Union[int, torch.Tensor]


def create_sin_embedding(positions: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """positions ``[B, T, 1]`` -> embeddings ``[B, T, dim]`` f32, cos first, then sin."""
    if dim % 2:
        raise ValueError(f"sinusoidal embeddings need an even dim, got {dim}")
    half = dim // 2
    adim = torch.arange(half, device=positions.device, dtype=torch.float32).reshape(1, 1, -1)
    phase = positions.float() / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


class MultiheadAttention(nn.Module):
    """Attention with torch ``MultiheadAttention``'s parameters (``in_proj_weight
    [3E, E]``, ``in_proj_bias``, ``out_proj``) and a boolean mask (True attends)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``q [B, T, E]``, ``kv [B, S, E]``, ``mask [T, S]`` -> ``[B, T, E]``."""
        E, H = q.shape[-1], self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        qh = F.linear(q, w[:E], b[:E])
        kh = F.linear(kv, w[E:2 * E], b[E:2 * E])
        vh = F.linear(kv, w[2 * E:], b[2 * E:])

        def split(x):
            B, T, _ = x.shape
            return x.reshape(B, T, H, E // H).transpose(1, 2)  # [B, H, T, hd]

        qh, kh, vh = split(qh), split(kh), split(vh)
        logits = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(E // H)
        attn = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
        out = torch.matmul(attn, vh).transpose(1, 2)
        return self.out_proj(out.reshape(q.shape))


class StreamingTransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer whose self-attention also sees the layer's past inputs."""

    def __init__(self, dim: int, num_heads: int, hidden_dim: int, gelu: bool = True, norm_eps: float = 1e-5):
        super().__init__()
        self.gelu = gelu
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.linear1 = nn.Linear(dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)

    def forward(self, x: torch.Tensor, x_past: torch.Tensor, past_context: int,
                offset: Optional[Offset] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [B, T, C]``, ``x_past [B, P, C]`` -> ``(y, x)``: the output and
        what the next step's past takes from this one."""
        T, P = x.shape[1], x_past.shape[1]
        keys = torch.cat([x_past, x], dim=1)
        q_pos = torch.arange(P, T + P, device=x.device).reshape(-1, 1)
        k_pos = torch.arange(T + P, device=x.device).reshape(1, -1)
        delta = q_pos - k_pos
        valid = (delta >= 0) & (delta <= past_context)
        if offset is not None:  # buffer slot i holds absolute position offset - P + i
            valid = valid & (offset - P + k_pos >= 0)
        y = self.norm1(x + self.self_attn(x, keys, valid))
        h = self.linear1(y)
        h = F.gelu(h) if self.gelu else F.relu(h)
        return self.norm2(y + self.linear2(h)), x


class StreamingTransformerEncoder(nn.Module):
    """``forward(x [B, T, C], states, offset) -> (y, next states, offset + T)``."""

    def __init__(self, dim: int, hidden_scale: float = 4.0, num_heads: int = 8, num_layers: int = 5,
                 max_period: float = 10000.0, past_context: int = 1000, gelu: bool = True, norm_in: bool = True):
        super().__init__()
        self.dim, self.max_period, self.past_context = dim, max_period, past_context
        # flax's LayerNorm default eps (1e-6), as the JAX package's norm_in has it
        self.norm_in = nn.LayerNorm(dim, eps=1e-6) if norm_in else nn.Identity()
        hidden = int(dim * hidden_scale)
        self.layers = nn.ModuleList(
            StreamingTransformerEncoderLayer(dim, num_heads, hidden, gelu=gelu) for _ in range(num_layers)
        )

    def init_states(self, batch: int, device=None, dtype=torch.float32) -> List[torch.Tensor]:
        """The rolling states of a new stream: ``[batch, past_context, dim]`` zeros per layer."""
        return [torch.zeros((batch, self.past_context, self.dim), device=device, dtype=dtype)
                for _ in self.layers]

    def forward(self, x: torch.Tensor, states: Optional[List[torch.Tensor]] = None, offset: Offset = 0,
                fixed_state: bool = False):
        """``fixed_state``: ``states`` are rolling buffers (:meth:`init_states`,
        the default when None) whose slots before the stream's start are
        masked; otherwise states grow from one zero frame, as JAX's default."""
        B, T, C = x.shape
        if states is None:
            if fixed_state:
                states = self.init_states(B, x.device, x.dtype)
            else:
                states = [torch.zeros_like(x[:, :1]) for _ in self.layers]
        positions = torch.arange(T, device=x.device).reshape(1, -1, 1) + offset
        x = self.norm_in(x) + create_sin_embedding(positions, C, self.max_period)
        new_states = []
        for layer, past in zip(self.layers, states):
            x, seen = layer(x, past, self.past_context, offset=offset if fixed_state else None)
            new_states.append(torch.cat([past, seen], dim=1)[:, -self.past_context:])
        return x, new_states, offset + T
