"""Plain PyTorch reference of Mimi (Kyutai), the codec of the ``mimi`` family.

Written from moshi's equations (moshi/models/compression.py ``MimiModel``,
modules/seanet.py, modules/conv.py, modules/resample.py,
modules/transformer.py, quantization/vq.py; the numbers of
moshi/models/loaders.py and HF ``kyutai/mimi`` ``config.json``):

* SEANet encoder: causal convs (all padding on the left, constant zeros,
  extra right padding so the last window is full), ELU, one resnet block a
  ratio with an identity skip (``true_skip``) and a ``dim / compress``
  hidden width, a strided conv (kernel ``2 r``) a ratio, ELU and a last conv
  of ``last_kernel_size``; no LSTM, no norm, every conv with a bias.
* Transformer (one after the encoder, one before the decoder): pre-norm
  LayerNorm layers, ``x + ls1 * attn(norm1(x))`` then ``x + ls2 *
  linear2(gelu(linear1(norm2(x))))``, bias-free projections, RoPE on q and
  k, causal attention over a window: query ``t`` sees keys ``t - sliding_window
  + 1 .. t``. Attention is computed one query at a time against exactly its
  band of keys, so ``torch.utils.flop_counter`` counts the band's work.
* Resampling: a causal conv (k 4, stride 2, replicate padding, no bias) down
  to the frame rate, a causal depthwise conv-transpose (k 4, stride 2, no
  bias, the surplus trimmed on the right) back up.
* Split RVQ: ``num_semantic_quantizers`` codebooks and the rest, each part
  with bias-free 1x1 projections into ``codebook_dim`` and back, both parts
  quantizing the same latent; decode sums the parts' outputs. Greedy nearest
  rows, lowest index on ties.

Departures from moshi: RoPE turns moshi's interleaved pairs ``(2i, 2i + 1)``
(the HF checkpoint permutes its q/k rows for ``rotate_half``; with seeded
weights the two are the same model); codebooks are plain tables (moshi keeps
EMA sums); clips are served whole, not streamed. Parameters come from a
state dict in the port's key layout (:func:`param_specs`).

Every tensor is f32, or the ``dtype`` asked for (a plain bf16 computation is
the yardstick of ``compare.wav_err``); ``cast`` rounds every conv and matmul
operand (a control); the caller turns TF32 off. Imports torch alone.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Specs = Dict[str, Tuple[Tuple[int, ...], str, int]]  # name -> (shape, init kind, fan_in)
Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]
LAYER_SCALE_FAN_IN = 1  # LayerScales drawn U(-1, 1): the configuration's ``assumed`` says why


def encoder_hop(cfg: dict) -> int:
    return math.prod(cfg["upsampling_ratios"])


def frames_for(cfg: dict, n: int) -> int:
    """Codes frames of a clip of ``n`` samples: the encoder's strided convs and the
    downsample each round up."""
    return -(-n // (2 * encoder_hop(cfg)))


def _conv(specs: Specs, name: str, cin: int, cout: int, k: int, bias: bool = True, transpose: bool = False,
          groups: int = 1) -> None:
    shape = (cin, cout // groups, k) if transpose else (cout, cin // groups, k)
    fan_in = shape[1] * k
    specs[f"{name}.weight"] = (shape, "uniform", fan_in)
    if bias:
        specs[f"{name}.bias"] = ((cout,), "uniform", fan_in)


def _resblock(specs: Specs, name: str, dim: int, cfg: dict) -> None:
    hidden = dim // cfg["compress"]
    _conv(specs, f"{name}.block.1.conv.conv", dim, hidden, cfg["residual_kernel_size"])
    _conv(specs, f"{name}.block.3.conv.conv", hidden, dim, 1)


def _transformer(specs: Specs, name: str, cfg: dict) -> None:
    D, ffn = cfg["hidden_size"], cfg["intermediate_size"]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"{name}.layers.{layer}."
        specs[p + "self_attn.in_proj_weight"] = ((3 * D, D), "uniform", D)
        specs[p + "self_attn.out_proj.weight"] = ((D, D), "uniform", D)
        for norm in ("norm1", "norm2"):
            specs[p + norm + ".weight"] = ((D,), "ones", 0)
            specs[p + norm + ".bias"] = ((D,), "zeros", 0)
        specs[p + "linear1.weight"] = ((ffn, D), "uniform", D)
        specs[p + "linear2.weight"] = ((D, ffn), "uniform", ffn)
        for ls in ("layer_scale_1", "layer_scale_2"):
            specs[p + ls + ".scale"] = ((D,), "uniform", LAYER_SCALE_FAN_IN)


def _rvq(specs: Specs, name: str, layers: int, cfg: dict) -> None:
    D, c, K = cfg["hidden_size"], cfg["codebook_dim"], cfg["codebook_size"]
    _conv(specs, f"{name}.input_proj", D, c, 1, bias=False)
    _conv(specs, f"{name}.output_proj", c, D, 1, bias=False)
    for layer in range(layers):
        base = f"{name}.vq.layers.{layer}._codebook."
        specs[base + "embed"] = ((K, c), "codebook", 0)
        specs[base + "embed_avg"] = ((K, c), "codebook", 0)
        specs[base + "cluster_size"] = ((K,), "zeros", 0)
        specs[base + "inited"] = ((1,), "ones", 0)


def param_specs(cfg: dict) -> Specs:
    """Every parameter and codebook of the state dict, in the port's key layout."""
    nf, D, ratios = cfg["num_filters"], cfg["hidden_size"], cfg["upsampling_ratios"]
    k, last = cfg["kernel_size"], cfg["last_kernel_size"]
    specs: Specs = {}
    _conv(specs, "encoder.model.0.conv.conv", 1, nf, k)
    i, mult = 1, 1
    for r in reversed(ratios):
        _resblock(specs, f"encoder.model.{i}", mult * nf, cfg)
        _conv(specs, f"encoder.model.{i + 2}.conv.conv", mult * nf, 2 * mult * nf, 2 * r)
        i, mult = i + 3, mult * 2
    _conv(specs, f"encoder.model.{i + 1}.conv.conv", mult * nf, D, last)
    _transformer(specs, "encoder_transformer", cfg)
    _conv(specs, "downsample.conv.conv", D, D, 4, bias=False)
    semantic = cfg["num_semantic_quantizers"]
    _rvq(specs, "quantizer.rvq_first", semantic, cfg)
    _rvq(specs, "quantizer.rvq_rest", cfg["num_quantizers"] - semantic, cfg)
    _conv(specs, "upsample.convtr.convtr", D, D, 4, bias=False, transpose=True, groups=D)
    _transformer(specs, "decoder_transformer", cfg)
    mult = 2 ** len(ratios)
    _conv(specs, "decoder.model.0.conv.conv", D, mult * nf, k)
    i = 1
    for r in ratios:
        _conv(specs, f"decoder.model.{i + 1}.convtr.convtr", mult * nf, mult * nf // 2, 2 * r, transpose=True)
        _resblock(specs, f"decoder.model.{i + 2}", mult * nf // 2, cfg)
        i, mult = i + 3, mult // 2
    _conv(specs, f"decoder.model.{i + 1}.conv.conv", nf, 1, last)
    return specs


def _same(cast: Cast, t: torch.Tensor) -> torch.Tensor:
    return t if cast is None else cast(t)


class MimiReference:
    """Mimi's forward in plain f32 PyTorch over a state dict in the port's layout."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], cast: Cast = None,
                 dtype: torch.dtype = torch.float32):
        self.cfg, self.cast, self.dtype = cfg, cast, dtype
        self.sd = {k: v.to(dtype) for k, v in sd.items()}
        self.semantic = cfg["num_semantic_quantizers"]
        self.first = [self.sd[f"quantizer.rvq_first.vq.layers.{i}._codebook.embed"] for i in range(self.semantic)]
        self.rest = [self.sd[f"quantizer.rvq_rest.vq.layers.{i}._codebook.embed"]
                     for i in range(cfg["num_quantizers"] - self.semantic)]

    # ---------------------------------------------------------------- convs
    def sconv(self, name: str, x: torch.Tensor, k: int, stride: int = 1, pad_mode: str = "constant") -> torch.Tensor:
        """A causal conv whose last window is full (moshi StreamingConv1d, not streaming)."""
        total = k - stride
        n_frames = (x.shape[-1] - k + total) / stride + 1
        extra = (math.ceil(n_frames) - 1) * stride + (k - total) - x.shape[-1]
        x = F.pad(x, (total, extra), mode=pad_mode)
        c = self.cast
        return F.conv1d(_same(c, x), _same(c, self.sd[f"{name}.weight"]), self.sd.get(f"{name}.bias"), stride=stride)

    def sconvtr(self, name: str, x: torch.Tensor, k: int, stride: int, groups: int = 1) -> torch.Tensor:
        """A causal conv-transpose, its ``k - stride`` surplus trimmed on the right."""
        c = self.cast
        y = F.conv_transpose1d(_same(c, x), _same(c, self.sd[f"{name}.weight"]), self.sd.get(f"{name}.bias"),
                               stride=stride, groups=groups)
        return y[..., : y.shape[-1] - (k - stride)]

    def resblock(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.sconv(f"{name}.block.1.conv.conv", F.elu(x), self.cfg["residual_kernel_size"])
        return x + self.sconv(f"{name}.block.3.conv.conv", F.elu(y), 1)

    def proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A bias-free 1x1 conv on ``[B, C, T]``."""
        return F.conv1d(_same(self.cast, x), _same(self.cast, self.sd[f"{name}.weight"]))

    # ---------------------------------------------------------------- transformer
    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return torch.matmul(_same(self.cast, x), _same(self.cast, self.sd[name]).t())

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, H, T, hd]``: pair ``(2i, 2i + 1)`` turned by ``t * rope_theta ** (-2i / hd)``, in f32."""
        hd, T = x.shape[-1], x.shape[-2]
        freqs = torch.exp(torch.arange(hd // 2, device=x.device, dtype=torch.float32)
                          * (-math.log(self.cfg["rope_theta"]) * 2 / hd))
        angle = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * freqs
        re, im = x.float().reshape(*x.shape[:-1], hd // 2, 2).unbind(-1)
        out = torch.stack([re * angle.cos() - im * angle.sin(), re * angle.sin() + im * angle.cos()], dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``[B, H, T, hd]`` each: every query against exactly its window of keys."""
        c, W = self.cast, self.cfg["sliding_window"]
        q, k, v = _same(c, q * q.shape[-1] ** -0.5), _same(c, k), _same(c, v)
        out = []
        for t in range(q.shape[2]):
            lo = max(0, t - W + 1)
            p = torch.softmax(torch.matmul(q[:, :, t:t + 1], k[:, :, lo:t + 1].transpose(-1, -2)), dim=-1)
            out.append(torch.matmul(_same(c, p), v[:, :, lo:t + 1]))
        return torch.cat(out, dim=2)

    def transformer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``[B, D, T]`` -> ``[B, D, T]``."""
        cfg = self.cfg
        B, D, T = x.shape
        H = cfg["num_attention_heads"]
        h = x.transpose(1, 2)
        for layer in range(cfg["num_hidden_layers"]):
            p = f"{name}.layers.{layer}."
            norm = lambda y, n: F.layer_norm(y, (D,), self.sd[p + n + ".weight"], self.sd[p + n + ".bias"],  # noqa: E731
                                             cfg["norm_eps"])
            q, k, v = self.linear(norm(h, "norm1"), p + "self_attn.in_proj_weight").reshape(
                B, T, 3, H, D // H).permute(2, 0, 3, 1, 4)
            a = self.attention(self.rope(q), self.rope(k), v).transpose(1, 2).reshape(B, T, D)
            h = h + self.sd[p + "layer_scale_1.scale"] * self.linear(a, p + "self_attn.out_proj.weight")
            f = self.linear(F.gelu(self.linear(norm(h, "norm2"), p + "linear1.weight")), p + "linear2.weight")
            h = h + self.sd[p + "layer_scale_2.scale"] * f
        return h.transpose(1, 2)

    # ---------------------------------------------------------------- towers
    def encoder(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> the frames the quantizer sees ``[B, D, frames]``."""
        cfg = self.cfg
        x = self.sconv("encoder.model.0.conv.conv", wav[:, None, :].to(self.dtype), cfg["kernel_size"])
        i = 1
        for r in reversed(cfg["upsampling_ratios"]):
            x = self.resblock(f"encoder.model.{i}", x)
            x = self.sconv(f"encoder.model.{i + 2}.conv.conv", F.elu(x), 2 * r, stride=r)
            i += 3
        x = self.sconv(f"encoder.model.{i + 1}.conv.conv", F.elu(x), cfg["last_kernel_size"])
        x = self.transformer("encoder_transformer", x)
        return self.sconv("downsample.conv.conv", x, 4, stride=2, pad_mode="replicate")

    def decoder(self, q: torch.Tensor) -> torch.Tensor:
        """The quantized frames ``[B, D, frames]`` -> wav ``[B, T]``."""
        cfg = self.cfg
        x = self.sconvtr("upsample.convtr.convtr", q, 4, 2, groups=cfg["hidden_size"])
        x = self.transformer("decoder_transformer", x)
        x = self.sconv("decoder.model.0.conv.conv", x, cfg["kernel_size"])
        i = 1
        for r in cfg["upsampling_ratios"]:
            x = self.sconvtr(f"decoder.model.{i + 1}.convtr.convtr", F.elu(x), 2 * r, r)
            x = self.resblock(f"decoder.model.{i + 2}", x)
            i += 3
        return self.sconv(f"decoder.model.{i + 1}.conv.conv", F.elu(x), cfg["last_kernel_size"])[:, 0]

    # ---------------------------------------------------------------- quantizer
    def latents(self, wav: torch.Tensor) -> torch.Tensor:
        """The two parts' projected frames side by side ``[B * frames, 2 * codebook_dim]``:
        the first part's inputs, then the rest's, as one residual chain sees them."""
        z = self.encoder(wav)
        x = torch.cat([self.proj("quantizer.rvq_first.input_proj", z),
                       self.proj("quantizer.rvq_rest.input_proj", z)], dim=1)
        return x.transpose(1, 2).reshape(-1, x.shape[1])

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> codes ``[num_quantizers, B, frames]``: each part's greedy
        residual search over its own projection of the frames."""
        B = wav.shape[0]
        x = self.latents(wav)
        c = self.cfg["codebook_dim"]
        codes = []
        for part, r in ((self.first, x[:, :c]), (self.rest, x[:, c:])):
            for book in part:
                idx = nearest(r, book)
                codes.append(idx)
                r = r - book[idx]
        return torch.stack(codes).reshape(len(codes), B, -1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> wav ``[B, T]``."""
        codes = codes.long()
        s = self.semantic
        out = self.proj("quantizer.rvq_first.output_proj", _lookup(self.first, codes[:s]))
        if codes.shape[0] > s:
            out = out + self.proj("quantizer.rvq_rest.output_proj", _lookup(self.rest, codes[s:]))
        return self.decoder(out)

    def books_for_search(self) -> List[torch.Tensor]:
        """Every codebook in search order as one residual chain over :meth:`latents`,
        each ``[groups = 1, K, 2 * codebook_dim]``: a part's rows in its own half, zeros
        in the other's (which adds the same distance to every row of a layer)."""
        zeros = torch.zeros_like(self.first[0])
        return ([torch.cat([b, zeros], dim=1)[None] for b in self.first]
                + [torch.cat([zeros, b], dim=1)[None] for b in self.rest])


def _lookup(books: List[torch.Tensor], codes: torch.Tensor) -> torch.Tensor:
    """The sum of the chosen rows ``[B, codebook_dim, frames]`` of codes ``[n, B, frames]``."""
    return sum(books[i][codes[i]] for i in range(codes.shape[0])).transpose(1, 2)


def nearest(r: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """Row of ``book [K, D]`` nearest each row of ``r [N, D]`` (lowest index on ties)."""
    dist = r.square().sum(1, keepdim=True) - 2.0 * r @ book.t() + book.square().sum(1)
    return dist.argmin(dim=1)
