"""Plain PyTorch reference of the Descript Audio Codec (DAC) for the port's tests.

Written from descript-audio-codec's equations (dac/model/dac.py ``Encoder``,
``Decoder``, ``EncoderBlock``, ``DecoderBlock``, ``ResidualUnit``;
dac/nn/layers.py ``Snake1d``, ``WNConv1d``, ``WNConvTranspose1d``;
dac/nn/quantize.py ``VectorQuantize``, ``ResidualVectorQuantize``), with
the numbers of HF ``descript/dac_44khz`` ``config.json`` as defaults. f32
throughout, TF32 off by the caller; no fused epilogue, no batching trick.
Imports torch alone.

* Every conv is weight-normed (``g * v / ||v||``, the norm over all but dim
  0), has a bias and pads with zeros on both sides.
* Snake: ``x + (alpha + 1e-9)^-1 * sin(alpha x)^2``, ``alpha [1, C, 1]``.
* ResidualUnit(C, d): ``x + conv_1x1(Snake(conv_k7_dil_d_pad_3d(Snake(x))))``
  (DAC's centre crop of ``x`` is a no-op: lengths match).
* Encoder: conv(1 -> C0, k 7, pad 3); per stride s: three residual units at
  dilations 1, 3, 9, Snake, conv(C -> 2C, k 2s, stride s, pad ceil(s / 2));
  Snake, conv(-> latent, k 3, pad 1). Decoder: conv(latent -> C0, k 7,
  pad 3); per rate s: Snake, conv-transpose(C -> C / 2, k 2s, stride s,
  pad ceil(s / 2)), three residual units; Snake, conv(-> 1, k 7, pad 3), tanh.
* RVQ, per layer with residual r: ``p = in_proj(r)``; the code is the argmin
  of ``|p^|^2 - 2 p^.c^ + |c^|^2`` over the ``F.normalize``d codebook rows
  (lowest index on ties); ``q = out_proj(codebook[code])`` of the
  unnormalized row; ``r = r - q``. Decoding sums the layers' ``q``.
* The clip is zero-padded on the right to a multiple of the hop.

Departures from DAC: codebooks are plain tables read from a state dict in the
port's key layout (DAC's own); quantizer dropout and the training losses
are left out (serving).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

DEFAULTS = dict(encoder_dim=64, encoder_rates=(2, 4, 8, 8), latent_dim=1024, decoder_dim=1536,
                decoder_rates=(8, 8, 4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=8)
DILATIONS = (1, 3, 9)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return x + (alpha + 1e-9).reciprocal() * torch.sin(alpha * x).pow(2)


class DACReference:
    """``cfg``: the preset's keywords that shape the model (:data:`DEFAULTS`)."""

    def __init__(self, sd: Dict[str, torch.Tensor], **cfg):
        self.cfg = {**DEFAULTS, **cfg}
        self.sd = {k: v.float() for k, v in sd.items()}
        self.hop = math.prod(self.cfg["encoder_rates"])

    def weight(self, name: str) -> torch.Tensor:
        v, g = self.sd[f"{name}.weight_v"], self.sd[f"{name}.weight_g"]
        return g * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt()

    def conv(self, name, x, stride=1, padding=0, dilation=1):
        return F.conv1d(x, self.weight(name), self.sd[f"{name}.bias"], stride=stride, padding=padding,
                        dilation=dilation)

    def convtr(self, name, x, stride, padding):
        return F.conv_transpose1d(x, self.weight(name), self.sd[f"{name}.bias"], stride=stride, padding=padding)

    def snake(self, name, x):
        return snake(x, self.sd[f"{name}.alpha"])

    def residual_unit(self, name, x, dilation):
        y = self.conv(f"{name}.block.1", self.snake(f"{name}.block.0", x), padding=3 * dilation, dilation=dilation)
        return x + self.conv(f"{name}.block.3", self.snake(f"{name}.block.2", y))

    def encoder(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> latent ``[B, latent_dim, ceil(T / hop)]``."""
        T = wav.shape[-1]
        x = F.pad(wav.float(), (0, -(-T // self.hop) * self.hop - T))[:, None, :]
        x = self.conv("encoder.block.0", x, padding=3)
        rates = self.cfg["encoder_rates"]
        for i, s in enumerate(rates, start=1):
            for j, d in enumerate(DILATIONS):
                x = self.residual_unit(f"encoder.block.{i}.block.{j}", x, d)
            x = self.snake(f"encoder.block.{i}.block.3", x)
            x = self.conv(f"encoder.block.{i}.block.4", x, stride=s, padding=math.ceil(s / 2))
        n = len(rates)
        return self.conv(f"encoder.block.{n + 2}", self.snake(f"encoder.block.{n + 1}", x), padding=1)

    def decoder(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, latent_dim, frames]`` -> wav ``[B, frames x hop]``."""
        x = self.conv("decoder.model.0", z, padding=3)
        rates = self.cfg["decoder_rates"]
        for i, s in enumerate(rates, start=1):
            x = self.snake(f"decoder.model.{i}.block.0", x)
            x = self.convtr(f"decoder.model.{i}.block.1", x, s, math.ceil(s / 2))
            for j, d in enumerate(DILATIONS):
                x = self.residual_unit(f"decoder.model.{i}.block.{j + 2}", x, d)
        n = len(rates)
        x = self.conv(f"decoder.model.{n + 2}", self.snake(f"decoder.model.{n + 1}", x), padding=3)
        return torch.tanh(x)[:, 0]

    def proj(self, name, x):
        """A 1x1 conv on rows ``[N, C]``."""
        return x @ self.weight(name)[:, :, 0].t() + self.sd[f"{name}.bias"]

    def book(self, i):
        return self.sd[f"quantizer.quantizers.{i}.codebook.weight"]

    def quantize(self, z: torch.Tensor, n_q: int = None) -> torch.Tensor:
        """latent ``[B, D, frames]`` -> codes ``[n_q, B, frames]``."""
        B, D, Fr = z.shape
        r = z.transpose(1, 2).reshape(-1, D)
        codes = []
        for i in range(n_q or self.cfg["n_codebooks"]):
            e = F.normalize(self.proj(f"quantizer.quantizers.{i}.in_proj", r))
            c = F.normalize(self.book(i))
            dist = e.pow(2).sum(1, keepdim=True) - 2 * e @ c.t() + c.pow(2).sum(1, keepdim=True).t()
            idx = dist.argmin(dim=1)
            codes.append(idx)
            r = r - self.proj(f"quantizer.quantizers.{i}.out_proj", self.book(i)[idx])
        return torch.stack(codes).reshape(len(codes), B, Fr)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> ``[B, D, frames]``: the layers' ``q`` summed."""
        n, B, Fr = codes.shape
        flat = codes.long().reshape(n, -1)
        q = sum(self.proj(f"quantizer.quantizers.{i}.out_proj", self.book(i)[flat[i]]) for i in range(n))
        return q.reshape(B, Fr, -1).transpose(1, 2)

    def encode(self, wav: torch.Tensor, n_q: int = None) -> torch.Tensor:
        return self.quantize(self.encoder(wav), n_q)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.dequantize(codes))
