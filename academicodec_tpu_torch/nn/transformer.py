"""Two transformers: the token LM's chunk-streamable trunk, and Mimi's sliding-window one.

**The LM's trunk** (:class:`StreamingTransformerEncoder`).

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

**Mimi's transformer** (:class:`SlidingWindowTransformer`, moshi's
``StreamingTransformer`` as Mimi configures it: moshi/modules/transformer.py
and moshi/models/loaders.py ``_transformer_kwargs``). Pre-norm layers
``x + ls1 * attn(norm1(x))`` then ``x + ls2 * ffn(norm2(x))``: LayerNorm,
LayerScale (a learnt per-channel scale) on both branches, bias-free
projections, a GELU feed-forward, RoPE on queries and keys (moshi's
interleaved pairs, computed in f32) and causal attention over a sliding
window, query ``t`` seeing keys ``t - context + 1 .. t``. Serving runs it
over whole clips, not streamed: the window is computed in blocks of
:data:`QUERY_BLOCK` queries, each against the keys its band can reach, one
``scaled_dot_product_attention`` call over every block of every clip, so
no ``T x T`` score matrix is built. Each forward counts ``attn.pairs`` (the
band's query-key pairs) and ``attn.pairs_computed`` (the pairs the blocks
score, masked ones included) from host shapes (``utils/profiling.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.utils import profiling

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


# ---------------------------------------------------------------------------
# Mimi's sliding-window transformer

QUERY_BLOCK = 64  # queries a block; its keys are padded to a multiple of KEY_ALIGN
KEY_ALIGN = 16  # the fused attention kernels read a mask whose rows are 16-element aligned


def band_pairs(T: int, context: int) -> int:
    """Query-key pairs of a causal window of ``context`` keys over ``T`` frames:
    ``sum_t min(t + 1, context)``."""
    w = min(T, context)
    return w * (w + 1) // 2 + (T - w) * context


def apply_rope(x: torch.Tensor, offset: int = 0, max_period: float = 10000.0) -> torch.Tensor:
    """moshi's rotary embedding of ``x [B, H, T, D]``: each pair of dims ``(2i, 2i + 1)``
    turned by the angle ``(offset + t) * max_period ** (-2i / D)``, in f32, back in x's dtype."""
    D, T = x.shape[-1], x.shape[-2]
    freqs = torch.exp(torch.arange(D // 2, device=x.device, dtype=torch.float32) * (-math.log(max_period) * 2 / D))
    angle = (torch.arange(T, device=x.device, dtype=torch.float32) + offset)[:, None] * freqs  # [T, D / 2]
    cos, sin = angle.cos(), angle.sin()
    re, im = x.float().unflatten(-1, (D // 2, 2)).unbind(-1)
    return torch.stack([re * cos - im * sin, re * sin + im * cos], dim=-1).flatten(-2).to(x.dtype)


class WindowBlocks:
    """The blocked layout of a window over ``T`` frames: ``blocks`` query blocks of
    ``QUERY_BLOCK`` (the last padded), each against ``span`` keys ending at its last
    query (``lead = span - QUERY_BLOCK`` of them before its first), and the additive
    mask ``[B * blocks, 1, QUERY_BLOCK, span]`` (0 where query sees key, -inf elsewhere)."""

    def __init__(self, B: int, T: int, context: int, device, dtype):
        q = QUERY_BLOCK
        self.T, self.blocks = T, -(-T // q)
        self.span = -(-(q + context - 1) // KEY_ALIGN) * KEY_ALIGN
        self.lead = self.span - q
        j = torch.arange(self.blocks, device=device)[:, None, None]
        i = torch.arange(q, device=device)[None, :, None]
        m = torch.arange(self.span, device=device)[None, None, :]
        delta = i + self.lead - m  # query position minus key position
        sees = (delta >= 0) & (delta < context) & (j * q - self.lead + m >= 0)
        mask = torch.zeros(sees.shape, device=device, dtype=dtype).masked_fill_(~sees, float("-inf"))
        self.mask = mask[:, None].repeat(B, 1, 1, 1)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``q, k, v [B, H, T, hd]`` -> ``[B, H, T, hd]``."""
        B, H, T, hd = q.shape
        n, qb = self.blocks, QUERY_BLOCK
        pad = n * qb - T

        def keys(x):  # [B, H, lead + n * qb, hd] -> [B * n, H, span, hd]
            x = F.pad(x, (0, 0, self.lead, pad)).unfold(2, self.span, qb)  # [B, H, n, hd, span]
            return x.permute(0, 2, 1, 4, 3).reshape(B * n, H, self.span, hd)

        qs = F.pad(q, (0, 0, 0, pad)).reshape(B, H, n, qb, hd).transpose(1, 2).reshape(B * n, H, qb, hd)
        out = F.scaled_dot_product_attention(qs, keys(k), keys(v), attn_mask=self.mask)
        return out.reshape(B, n, H, qb, hd).transpose(1, 2).reshape(B, H, n * qb, hd)[:, :, :T]


class LayerScale(nn.Module):
    """A learnt per-channel scale of a residual branch (moshi ``LayerScale``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.full((dim,), 0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x


class SlidingWindowAttention(nn.Module):
    """Bias-free packed projections (``in_proj_weight [3E, E]``, ``out_proj``), RoPE
    on queries and keys, the window's blocked attention."""

    def __init__(self, dim: int, num_heads: int, max_period: float):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads, self.max_period = num_heads, max_period
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor, blocks: WindowBlocks) -> torch.Tensor:
        B, T, E = x.shape
        H = self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight).reshape(B, T, 3, H, E // H).permute(2, 0, 3, 1, 4)
        q, k = apply_rope(q, 0, self.max_period), apply_rope(k, 0, self.max_period)
        return self.out_proj(blocks.attend(q, k, v).transpose(1, 2).reshape(B, T, E))


class SlidingWindowTransformerLayer(nn.Module):
    """Pre-norm layer with LayerScale on both branches and a bias-free GELU feed-forward."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, max_period: float, norm_eps: float = 1e-5):
        super().__init__()
        self.self_attn = SlidingWindowAttention(dim, num_heads, max_period)
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.linear1 = nn.Linear(dim, ffn_dim, bias=False)
        self.linear2 = nn.Linear(ffn_dim, dim, bias=False)
        self.layer_scale_1 = LayerScale(dim)
        self.layer_scale_2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, blocks: WindowBlocks) -> torch.Tensor:
        x = x + self.layer_scale_1(self.self_attn(self.norm1(x), blocks))
        return x + self.layer_scale_2(self.linear2(F.gelu(self.linear1(self.norm2(x)))))


class SlidingWindowTransformer(nn.Module):
    """``forward(x [B, T, C]) -> [B, T, C]`` over whole clips (module docstring)."""

    def __init__(self, dim: int = 512, num_heads: int = 8, num_layers: int = 8, ffn_dim: int = 2048,
                 context: int = 250, max_period: float = 10000.0, norm_eps: float = 1e-5):
        super().__init__()
        self.context = context
        self.layers = nn.ModuleList(
            SlidingWindowTransformerLayer(dim, num_heads, ffn_dim, max_period, norm_eps) for _ in range(num_layers)
        )

    def reset_parameters(self, generator: torch.Generator, layer_scale: float) -> None:
        """Projections U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default init),
        LayerNorms 1 and 0, every LayerScale ``layer_scale``."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("scale"):
                    p.fill_(layer_scale)
                elif "norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    bound = 1.0 / math.sqrt(p.shape[1])
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        blocks = WindowBlocks(B, T, self.context, x.device, x.dtype)
        profiling.count("attn.pairs", B * len(self.layers) * band_pairs(T, self.context))
        profiling.count("attn.pairs_computed", B * len(self.layers) * blocks.blocks * QUERY_BLOCK * blocks.span)
        for layer in self.layers:
            x = layer(x, blocks)
        return x
