"""Plain PyTorch reference of the Descript Audio Codec (DAC), the codec of the ``dac`` family.

Written from descript-audio-codec's equations (dac/model/dac.py ``Encoder``,
``Decoder``, ``EncoderBlock``, ``DecoderBlock``, ``ResidualUnit``;
dac/nn/layers.py ``Snake1d``, ``WNConv1d``, ``WNConvTranspose1d``;
dac/nn/quantize.py ``VectorQuantize``, ``ResidualVectorQuantize``), with the
numbers of HF ``descript/dac_44khz`` ``config.json`` (``DacConfig`` keys):

* every conv weight-normed (``g * v / ||v||``, the norm over all dims but
  0), with a bias, zero padding on both sides;
* Snake: ``x + (alpha + 1e-9)^-1 * sin(alpha x)^2``, ``alpha [1, C, 1]``;
* ResidualUnit(C, d): ``x + conv_1x1(Snake(conv_k7_dil_d_pad_3d(Snake(x))))``
  (DAC's centre crop of ``x`` is a no-op: lengths match);
* encoder: conv(1 -> ``encoder_hidden_size``, k 7, pad 3); per
  ``downsampling_ratios`` s, doubling the channels: three residual units at
  dilations 1, 3, 9, Snake, conv(C -> 2C, k 2s, stride s, pad ceil(s / 2));
  Snake, conv(-> ``hidden_size``, k 3, pad 1);
* decoder: conv(``hidden_size`` -> ``decoder_hidden_size``, k 7, pad 3); per
  ``upsampling_ratios`` s, halving them: Snake, conv-transpose(C -> C / 2,
  k 2s, stride s, pad ceil(s / 2)), three residual units; Snake, conv(-> 1,
  k 7, pad 3), tanh;
* RVQ, ``n_codebooks`` layers, with residual r: ``p = in_proj(r)`` (1x1,
  ``hidden_size -> codebook_dim``); the code is the argmin of ``|p^|^2 -
  2 p^.c^ + |c^|^2`` over the ``F.normalize``d codebook rows (eps 1e-12,
  lowest index on ties); ``q = out_proj(codebook[code])`` of the unnormalized
  row; ``r = r - q``. Decoding sums the layers' ``q``;
* the clip is zero-padded on the right to a multiple of the hop.

Departures from DAC: codebooks are plain tables; quantizer dropout and the
training losses are left out (serving). Parameters come from a state dict
in the port's key layout (DAC's own, :func:`param_specs`).

Every tensor is f32, or the ``dtype`` asked for (a plain bf16 computation,
the Snake included, is the yardstick of ``compare.wav_err``); ``cast``
rounds every conv and projection operand (a control); the caller turns TF32
off. The search's distances are never cast. Imports torch alone.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Specs = Dict[str, Tuple[Tuple[int, ...], str, int]]  # name -> (shape, init kind, fan_in)
Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]
DILATIONS = (1, 3, 9)
ALPHA_FAN_IN = 1  # alphas drawn U(-1, 1) as exponents: the family makes them 5 ** u


def hop(cfg: dict) -> int:
    return math.prod(cfg["downsampling_ratios"])


def frames_for(cfg: dict, n: int) -> int:
    """Codes frames of a clip of ``n`` samples: the clip padded to a multiple of the hop."""
    return -(-n // hop(cfg))


def _conv(specs: Specs, name: str, cin: int, cout: int, k: int, transpose: bool = False) -> None:
    shape = (cin, cout, k) if transpose else (cout, cin, k)
    fan_in = shape[1] * k
    specs[f"{name}.weight_g"] = ((shape[0], 1, 1), "norm_of_v", 0)
    specs[f"{name}.weight_v"] = (shape, "uniform", fan_in)
    specs[f"{name}.bias"] = ((cout,), "uniform", fan_in)


def _snake(specs: Specs, name: str, c: int) -> None:
    specs[f"{name}.alpha"] = ((1, c, 1), "uniform", ALPHA_FAN_IN)


def _unit(specs: Specs, name: str, c: int) -> None:
    _snake(specs, f"{name}.block.0", c)
    _conv(specs, f"{name}.block.1", c, c, 7)
    _snake(specs, f"{name}.block.2", c)
    _conv(specs, f"{name}.block.3", c, c, 1)


def param_specs(cfg: dict) -> Specs:
    """Every parameter and codebook of the state dict, in the port's key layout."""
    specs: Specs = {}
    c = cfg["encoder_hidden_size"]
    _conv(specs, "encoder.block.0", 1, c, 7)
    ratios = cfg["downsampling_ratios"]
    for i, s in enumerate(ratios, start=1):
        for j in range(len(DILATIONS)):
            _unit(specs, f"encoder.block.{i}.block.{j}", c)
        _snake(specs, f"encoder.block.{i}.block.3", c)
        _conv(specs, f"encoder.block.{i}.block.4", c, 2 * c, 2 * s)
        c *= 2
    _snake(specs, f"encoder.block.{len(ratios) + 1}", c)
    D = cfg["hidden_size"]
    _conv(specs, f"encoder.block.{len(ratios) + 2}", c, D, 3)
    for i in range(cfg["n_codebooks"]):
        base = f"quantizer.quantizers.{i}"
        _conv(specs, f"{base}.in_proj", D, cfg["codebook_dim"], 1)
        _conv(specs, f"{base}.out_proj", cfg["codebook_dim"], D, 1)
        specs[f"{base}.codebook.weight"] = ((cfg["codebook_size"], cfg["codebook_dim"]), "codebook", 0)
    c = cfg["decoder_hidden_size"]
    _conv(specs, "decoder.model.0", D, c, 7)
    rates = cfg["upsampling_ratios"]
    for i, s in enumerate(rates, start=1):
        _snake(specs, f"decoder.model.{i}.block.0", c)
        _conv(specs, f"decoder.model.{i}.block.1", c, c // 2, 2 * s, transpose=True)
        c //= 2
        for j in range(len(DILATIONS)):
            _unit(specs, f"decoder.model.{i}.block.{j + 2}", c)
    _snake(specs, f"decoder.model.{len(rates) + 1}", c)
    _conv(specs, f"decoder.model.{len(rates) + 2}", c, 1, 7)
    return specs


def _same(cast: Cast, t: torch.Tensor) -> torch.Tensor:
    return t if cast is None else cast(t)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return x + (alpha + 1e-9).reciprocal() * torch.sin(alpha * x).pow(2)


class DacReference:
    """DAC's forward in plain f32 PyTorch over a state dict in the port's layout."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], cast: Cast = None,
                 dtype: torch.dtype = torch.float32):
        self.cfg, self.cast, self.dtype = cfg, cast, dtype
        self.sd = {k: v.to(dtype) for k, v in sd.items()}
        self.n_q = cfg["n_codebooks"]

    # ---------------------------------------------------------------- towers
    def weight(self, name: str) -> torch.Tensor:
        v, g = self.sd[f"{name}.weight_v"], self.sd[f"{name}.weight_g"]
        return g * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt()

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0, dilation: int = 1):
        c = self.cast
        return F.conv1d(_same(c, x), _same(c, self.weight(name)), self.sd[f"{name}.bias"], stride=stride,
                        padding=padding, dilation=dilation)

    def convtr(self, name: str, x: torch.Tensor, stride: int, padding: int):
        c = self.cast
        return F.conv_transpose1d(_same(c, x), _same(c, self.weight(name)), self.sd[f"{name}.bias"],
                                  stride=stride, padding=padding)

    def snake(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.sd[f"{name}.alpha"])

    def unit(self, name: str, x: torch.Tensor, d: int) -> torch.Tensor:
        y = self.conv(f"{name}.block.1", self.snake(f"{name}.block.0", x), padding=3 * d, dilation=d)
        return x + self.conv(f"{name}.block.3", self.snake(f"{name}.block.2", y))

    def encoder(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> latent ``[B, hidden_size, ceil(T / hop)]``."""
        T = wav.shape[-1]
        x = F.pad(wav.to(self.dtype), (0, frames_for(self.cfg, T) * hop(self.cfg) - T))[:, None, :]
        x = self.conv("encoder.block.0", x, padding=3)
        ratios = self.cfg["downsampling_ratios"]
        for i, s in enumerate(ratios, start=1):
            for j, d in enumerate(DILATIONS):
                x = self.unit(f"encoder.block.{i}.block.{j}", x, d)
            x = self.snake(f"encoder.block.{i}.block.3", x)
            x = self.conv(f"encoder.block.{i}.block.4", x, stride=s, padding=math.ceil(s / 2))
        n = len(ratios)
        return self.conv(f"encoder.block.{n + 2}", self.snake(f"encoder.block.{n + 1}", x), padding=1)

    def decoder(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, hidden_size, frames]`` -> wav ``[B, frames x hop]``."""
        x = self.conv("decoder.model.0", z.to(self.dtype), padding=3)
        rates = self.cfg["upsampling_ratios"]
        for i, s in enumerate(rates, start=1):
            x = self.snake(f"decoder.model.{i}.block.0", x)
            x = self.convtr(f"decoder.model.{i}.block.1", x, s, math.ceil(s / 2))
            for j, d in enumerate(DILATIONS):
                x = self.unit(f"decoder.model.{i}.block.{j + 2}", x, d)
        n = len(rates)
        return torch.tanh(self.conv(f"decoder.model.{n + 2}", self.snake(f"decoder.model.{n + 1}", x),
                                    padding=3))[:, 0]

    # ---------------------------------------------------------------- quantizer
    def proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 conv on rows ``[N, C]``."""
        c = self.cast
        return torch.matmul(_same(c, x), _same(c, self.weight(name)[:, :, 0]).t()) + self.sd[f"{name}.bias"]

    def book(self, i: int) -> torch.Tensor:
        return self.sd[f"quantizer.quantizers.{i}.codebook.weight"]

    def normalized_books(self) -> torch.Tensor:
        """Every layer's normalized codebook ``[n_codebooks, K, codebook_dim]``."""
        return torch.stack([F.normalize(self.book(i)) for i in range(self.n_q)])

    def latents(self, wav: torch.Tensor) -> torch.Tensor:
        """The latent frames the quantizer sees ``[B * frames, hidden_size]``, row-major."""
        z = self.encoder(wav)
        return z.transpose(1, 2).reshape(-1, z.shape[1])

    def projections(self, z: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """Following ``codes [N, n]`` layer by layer from the latent rows ``z [N, D]``:
        each layer's projection of its residual (``in_proj``, not normalized), side by
        side ``[N, n x codebook_dim]`` (DAC's search at that layer: the row of largest
        cosine to it)."""
        r, out = z, []
        for i in range(codes.shape[1]):
            out.append(self.proj(f"quantizer.quantizers.{i}.in_proj", r))
            r = r - self.proj(f"quantizer.quantizers.{i}.out_proj", self.book(i)[codes[:, i].long()])
        return torch.cat(out, dim=1)

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> codes ``[n_codebooks, B, frames]``: the residual search."""
        B = wav.shape[0]
        r = self.latents(wav)
        codes = []
        for i in range(self.n_q):
            idx = nearest(self.proj(f"quantizer.quantizers.{i}.in_proj", r), self.book(i))
            codes.append(idx)
            r = r - self.proj(f"quantizer.quantizers.{i}.out_proj", self.book(i)[idx])
        return torch.stack(codes).reshape(len(codes), B, -1)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> ``[B, hidden_size, frames]``: the layers' ``q`` summed."""
        n, B, Fr = codes.shape
        flat = codes.long().reshape(n, -1)
        q = sum(self.proj(f"quantizer.quantizers.{i}.out_proj", self.book(i)[flat[i]]) for i in range(n))
        return q.reshape(B, Fr, -1).transpose(1, 2)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> wav ``[B, frames x hop]``."""
        return self.decoder(self.dequantize(codes))

    def books_for_search(self, scales: torch.Tensor) -> List[torch.Tensor]:
        """The layers' normalized codebooks, layer ``i``'s times ``scales[i] > 0``, as one
        layer of ``n_codebooks`` groups: the layout ``compare.code_gaps`` takes beside
        :meth:`projections`. All rows of a layer have one length, so the nearest row to a
        projection ``p`` is the row of largest cosine to it: DAC's choice."""
        return [self.normalized_books() * scales.to(self.book(0).device).view(-1, 1, 1)]


def nearest(p: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """Row of ``book [K, d]`` cosine-nearest each row of ``p [N, d]``, as DAC computes it
    on ``F.normalize``d vectors (lowest index on ties)."""
    e, c = F.normalize(p.float()), F.normalize(book.float())
    dist = e.pow(2).sum(1, keepdim=True) - 2 * e @ c.t() + c.pow(2).sum(1, keepdim=True).t()
    return dist.argmin(dim=1)
