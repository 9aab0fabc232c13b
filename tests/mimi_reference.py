"""Plain PyTorch reference of Mimi (Kyutai's codec) for the port's tests.

Written from moshi's equations (moshi/models/compression.py ``MimiModel``,
modules/seanet.py, modules/conv.py, modules/resample.py,
modules/transformer.py, quantization/vq.py), with the numbers of
moshi/models/loaders.py as defaults. f32 throughout, TF32 off by the
caller; no batching tricks, no cache. Imports torch alone.

* SEANet: causal convs (zeros on the left, extra zeros on the right so the
  last window is full), ELU, per ratio one resnet block (identity skip,
  hidden ``dim / 2``, kernels 3 and 1) and a strided conv of kernel ``2 r``;
  first kernel 7, last 3; no LSTM, no norm, biases everywhere.
* Transformers: pre-norm LayerNorm (eps 1e-5) layers with LayerScale on both
  branches, bias-free projections, GELU, RoPE, and each query attending
  exactly its window of keys ``t - context + 1 .. t``, one query at a time.
* Resampling: causal conv k 4 stride 2 with replicate padding down, causal
  depthwise conv-transpose k 4 stride 2 up, no biases.
* Split RVQ: the first codebook and the other ``n_q - 1``, each part
  with its own 1x1 projections in and out, both on the same latent.

Departures from moshi: RoPE turns moshi's interleaved pairs ``(2i, 2i + 1)``,
as moshi does; the HF checkpoint's q/k rows are permuted for
``rotate_half``, which on seeded weights is the same model. Codebooks are
plain tables (moshi keeps EMA sums). Parameters are read from a state dict
in the port's key layout.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

DEFAULTS = dict(n_filters=64, dimension=512, ratios=(8, 6, 5, 4), num_layers=8, num_heads=8, ffn_dim=2048,
                context=250, n_q=32, codebook_dim=256, bins=2048)
KERNEL, LAST_KERNEL, RESIDUAL_KERNEL, NORM_EPS, MAX_PERIOD, SEMANTIC = 7, 3, 3, 1e-5, 10000.0, 1


class MimiReference:
    """``cfg``: the preset's keywords that shape the model (:data:`DEFAULTS`)."""

    def __init__(self, sd: Dict[str, torch.Tensor], **cfg):
        self.cfg = {**DEFAULTS, **cfg}
        self.sd = {k: v.float() for k, v in sd.items()}
        self.books = ([self.sd[f"quantizer.rvq_first.vq.layers.{i}._codebook.embed"] for i in range(SEMANTIC)]
                      + [self.sd[f"quantizer.rvq_rest.vq.layers.{i}._codebook.embed"]
                         for i in range(self.cfg["n_q"] - SEMANTIC)])

    def conv(self, name, x, k, stride=1, mode="constant"):
        total = k - stride
        extra = (math.ceil((x.shape[-1] - k + total) / stride + 1) - 1) * stride + (k - total) - x.shape[-1]
        return F.conv1d(F.pad(x, (total, extra), mode=mode), self.sd[f"{name}.weight"], self.sd.get(f"{name}.bias"),
                        stride=stride)

    def convtr(self, name, x, k, stride, groups=1):
        y = F.conv_transpose1d(x, self.sd[f"{name}.weight"], self.sd.get(f"{name}.bias"), stride=stride,
                               groups=groups)
        return y[..., : y.shape[-1] - (k - stride)]

    def resblock(self, name, x):
        y = self.conv(f"{name}.block.1.conv.conv", F.elu(x), RESIDUAL_KERNEL)
        return x + self.conv(f"{name}.block.3.conv.conv", F.elu(y), 1)

    def transformer(self, name, x):
        """``[B, D, T]`` -> ``[B, D, T]``."""
        cfg = self.cfg
        B, D, T = x.shape
        H, W = cfg["num_heads"], cfg["context"]
        hd = D // H
        ar = lambda n: torch.arange(n, dtype=torch.float32, device=x.device)  # noqa: E731
        angle = ar(T)[:, None] * torch.exp(ar(hd // 2) * (-math.log(MAX_PERIOD) * 2 / hd))

        def rope(u):  # [B, H, T, hd], pairs (2i, 2i + 1)
            re, im = u[..., 0::2], u[..., 1::2]
            return torch.stack([re * angle.cos() - im * angle.sin(), re * angle.sin() + im * angle.cos()],
                               dim=-1).reshape(u.shape)

        h = x.transpose(1, 2)
        for layer in range(cfg["num_layers"]):
            p = {k[len(f"{name}.layers.{layer}."):]: v for k, v in self.sd.items()
                 if k.startswith(f"{name}.layers.{layer}.")}
            y = F.layer_norm(h, (D,), p["norm1.weight"], p["norm1.bias"], NORM_EPS)
            q, k, v = (y @ p["self_attn.in_proj_weight"].t()).reshape(B, T, 3, H, hd).permute(2, 0, 3, 1, 4)
            q, k = rope(q), rope(k)
            rows = []
            for t in range(T):
                lo = max(0, t - W + 1)
                w = torch.softmax(q[:, :, t:t + 1] @ k[:, :, lo:t + 1].transpose(-1, -2) / math.sqrt(hd), dim=-1)
                rows.append(w @ v[:, :, lo:t + 1])
            a = torch.cat(rows, dim=2).transpose(1, 2).reshape(B, T, D)
            h = h + p["layer_scale_1.scale"] * (a @ p["self_attn.out_proj.weight"].t())
            y = F.layer_norm(h, (D,), p["norm2.weight"], p["norm2.bias"], NORM_EPS)
            h = h + p["layer_scale_2.scale"] * (F.gelu(y @ p["linear1.weight"].t()) @ p["linear2.weight"].t())
        return h.transpose(1, 2)

    def latent(self, wav):
        """wav ``[B, T]`` -> the quantizer's input ``[B, D, frames]``."""
        x = self.conv("encoder.model.0.conv.conv", wav[:, None, :].float(), KERNEL)
        i = 1
        for r in reversed(self.cfg["ratios"]):
            x = self.resblock(f"encoder.model.{i}", x)
            x = self.conv(f"encoder.model.{i + 2}.conv.conv", F.elu(x), 2 * r, stride=r)
            i += 3
        x = self.conv(f"encoder.model.{i + 1}.conv.conv", F.elu(x), LAST_KERNEL)
        x = self.transformer("encoder_transformer", x)
        return self.conv("downsample.conv.conv", x, 4, stride=2, mode="replicate")

    def projected(self, part, z):
        """A part's input: ``z [B, D, T]`` projected -> ``[B * T, codebook_dim]``."""
        y = F.conv1d(z, self.sd[f"quantizer.{part}.input_proj.weight"])
        return y.transpose(1, 2).reshape(-1, y.shape[1])

    def encode(self, wav):
        """wav ``[B, T]`` -> codes ``[n_q, B, frames]``."""
        z = self.latent(wav)
        s = SEMANTIC
        codes = []
        for part, books in (("rvq_first", self.books[:s]), ("rvq_rest", self.books[s:])):
            r = self.projected(part, z)
            for book in books:
                idx = (r.square().sum(1, keepdim=True) - 2 * r @ book.t() + book.square().sum(1)).argmin(1)
                codes.append(idx)
                r = r - book[idx]
        return torch.stack(codes).reshape(len(codes), wav.shape[0], -1)

    def dequantize(self, codes):
        """codes ``[n, B, frames]`` -> ``[B, D, frames]``: each part's rows summed and projected out."""
        s = SEMANTIC
        out = 0
        for part, lo, hi in (("rvq_first", 0, s), ("rvq_rest", s, codes.shape[0])):
            if hi > lo:
                q = sum(self.books[i][codes[i].long()] for i in range(lo, hi)).transpose(1, 2)
                out = out + F.conv1d(q, self.sd[f"quantizer.{part}.output_proj.weight"])
        return out

    def decode(self, codes):
        """codes ``[n, B, frames]`` -> wav ``[B, frames * hop]``."""
        x = self.convtr("upsample.convtr.convtr", self.dequantize(codes), 4, 2, groups=self.cfg["dimension"])
        x = self.transformer("decoder_transformer", x)
        x = self.conv("decoder.model.0.conv.conv", x, KERNEL)
        i = 1
        for r in self.cfg["ratios"]:
            x = self.convtr(f"decoder.model.{i + 1}.convtr.convtr", F.elu(x), 2 * r, r)
            x = self.resblock(f"decoder.model.{i + 2}", x)
            i += 3
        return self.conv(f"decoder.model.{i + 1}.conv.conv", F.elu(x), LAST_KERNEL)[:, 0]
