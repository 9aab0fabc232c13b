"""Plain PyTorch reference of the SoundStream / Encodec generator.

SEANet encoder -> greedy residual VQ -> SEANet decoder, written from the
reference recipe's description (AcademiCodec ``models/encodec/net3.py`` and
``modules/seanet.py``, ``modules/conv.py``, ``modules/lstm.py``,
``quantization/core_vq.py``): weight-normed convs with reflect padding that
keeps the framing exact, ELU activations, one resnet block per ratio with a
1x1 conv shortcut, a 2-layer LSTM bottleneck with a skip, and EMA-free
codebooks read as plain tables. Every tensor is f32 (or the ``dtype`` asked
for: a plain bf16 computation is the yardstick of ``compare.wav_err``); the
caller turns TF32 off. Parameters come from a reference-layout ``state_dict`` (the keys of a
reference ``.pth``); :func:`param_specs` lists them with their shapes.

The module imports torch alone: nothing of the measured package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Specs = Dict[str, Tuple[Tuple[int, ...], str, int]]  # name -> (shape, init kind, fan_in)
Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]  # rounds a conv or matmul operand (a control)


def frame_rate(cfg: dict) -> int:
    return math.ceil(cfg["sample_rate"] / math.prod(cfg["ratios"]))


def n_q(cfg: dict) -> int:
    """Codebooks at the top bandwidth (reference net3.py:25-26)."""
    return int(1000 * cfg["target_bandwidths"][-1] // (frame_rate(cfg) * 10))


def _conv(specs: Specs, name: str, cin: int, cout: int, k: int, transpose: bool = False) -> None:
    """A weight-normed conv: ``weight_v [O, I, K]`` (conv-transpose ``[I, O, K]``),
    ``weight_g`` per leading channel, ``bias [O]``."""
    shape = (cin, cout, k) if transpose else (cout, cin, k)
    fan_in = (cout if transpose else cin) * k
    specs[f"{name}.weight_v"] = (shape, "uniform", fan_in)
    specs[f"{name}.weight_g"] = ((shape[0], 1, 1), "norm_of_v", fan_in)
    specs[f"{name}.bias"] = ((cout,), "uniform", fan_in)


def _lstm(specs: Specs, name: str, dim: int) -> None:
    for layer in range(2):
        for kind in ("weight_ih", "weight_hh"):
            specs[f"{name}.lstm.{kind}_l{layer}"] = ((4 * dim, dim), "uniform", dim)
        for kind in ("bias_ih", "bias_hh"):
            specs[f"{name}.lstm.{kind}_l{layer}"] = ((4 * dim,), "uniform", dim)


def _resblock(specs: Specs, name: str, dim: int) -> None:
    hidden = dim // 2
    _conv(specs, f"{name}.block.1.conv.conv", dim, hidden, 3)
    _conv(specs, f"{name}.block.3.conv.conv", hidden, dim, 1)
    _conv(specs, f"{name}.shortcut.conv.conv", dim, dim, 1)


def param_specs(cfg: dict) -> Specs:
    """Every parameter and codebook of the reference ``state_dict``, in order."""
    nf, dim, ratios = cfg["n_filters"], cfg["dimension"], cfg["ratios"]
    specs: Specs = {}
    _conv(specs, "encoder.model.0.conv.conv", 1, nf, 7)
    i, mult = 1, 1
    for r in reversed(ratios):
        _resblock(specs, f"encoder.model.{i}", mult * nf)
        _conv(specs, f"encoder.model.{i + 2}.conv.conv", mult * nf, 2 * mult * nf, 2 * r)
        i, mult = i + 3, mult * 2
    _lstm(specs, f"encoder.model.{i}", mult * nf)
    _conv(specs, f"encoder.model.{i + 2}.conv.conv", mult * nf, dim, 7)
    mult = 2 ** len(ratios)
    _conv(specs, "decoder.model.0.conv.conv", dim, mult * nf, 7)
    _lstm(specs, "decoder.model.1", mult * nf)
    i = 2
    for r in ratios:
        _conv(specs, f"decoder.model.{i + 1}.convtr.convtr", mult * nf, mult * nf // 2, 2 * r, transpose=True)
        _resblock(specs, f"decoder.model.{i + 2}", mult * nf // 2)
        i, mult = i + 3, mult // 2
    _conv(specs, f"decoder.model.{i + 1}.conv.conv", nf, 1, 7)
    for layer in range(n_q(cfg)):
        base = f"quantizer.vq.layers.{layer}._codebook."
        specs[base + "embed"] = ((cfg["bins"], dim), "codebook", 0)
        specs[base + "embed_avg"] = ((cfg["bins"], dim), "codebook", 0)
        specs[base + "cluster_size"] = ((cfg["bins"],), "zeros", 0)
        specs[base + "inited"] = ((1,), "ones", 0)
    return specs


def _same(cast: Cast, t: torch.Tensor) -> torch.Tensor:
    return t if cast is None else cast(t)


class SoundStreamReference:
    """The generator's forward in plain f32 PyTorch over a reference ``state_dict``."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], cast: Cast = None,
                 dtype: torch.dtype = torch.float32):
        self.cfg, self.cast, self.dtype = cfg, cast, dtype
        self.sd = {k: v.to(dtype) for k, v in sd.items()}
        self.books = torch.stack([self.sd[f"quantizer.vq.layers.{i}._codebook.embed"] for i in range(n_q(cfg))])

    # ---------------------------------------------------------------- layers
    def _weight(self, name: str) -> torch.Tensor:
        v, g = self.sd[f"{name}.weight_v"], self.sd[f"{name}.weight_g"]
        return g * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt()

    def sconv(self, name: str, x: torch.Tensor, k: int, stride: int = 1, dilation: int = 1) -> torch.Tensor:
        """Reflect-padded conv whose last window is full (reference conv.py SConv1d)."""
        total = (k - 1) * dilation - (stride - 1)
        n_frames = (x.shape[-1] - k + total) / stride + 1
        extra = (math.ceil(n_frames) - 1) * stride + (k - total) - x.shape[-1]
        right = total // 2
        x = reflect_pad(x, total - right, right + extra)
        c = self.cast
        return F.conv1d(_same(c, x), _same(c, self._weight(name)), self.sd[f"{name}.bias"], stride=stride,
                        dilation=dilation)

    def sconvtr(self, name: str, x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
        c = self.cast
        y = F.conv_transpose1d(_same(c, x), _same(c, self._weight(name)), self.sd[f"{name}.bias"], stride=stride)
        total = k - stride
        right = total // 2
        return y[..., total - right: y.shape[-1] - right]

    def resblock(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.sconv(f"{name}.block.1.conv.conv", F.elu(x), 3)
        y = self.sconv(f"{name}.block.3.conv.conv", F.elu(y), 1)
        return self.sconv(f"{name}.shortcut.conv.conv", x, 1) + y

    def slstm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Two LSTM layers over ``x [B, C, T]`` step by step, plus the skip."""
        c = self.cast
        y = x.permute(2, 0, 1)
        for layer in range(2):
            p = lambda kind: self.sd[f"{name}.lstm.{kind}_l{layer}"]  # noqa: E731
            w_hh = _same(c, p("weight_hh"))
            proj = torch.matmul(_same(c, y), _same(c, p("weight_ih")).t()) + p("bias_ih") + p("bias_hh")
            h = y.new_zeros(y.shape[1], w_hh.shape[1])
            cell = torch.zeros_like(h)
            out = []
            for t in range(proj.shape[0]):
                i, f, g, o = (proj[t] + torch.matmul(_same(c, h), w_hh.t())).chunk(4, dim=-1)
                cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(cell)
                out.append(h)
            y = torch.stack(out)
        return y.permute(1, 2, 0) + x

    # ---------------------------------------------------------------- towers
    def encoder(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> latents ``[B, D, frames]``."""
        ratios = self.cfg["ratios"]
        x = self.sconv("encoder.model.0.conv.conv", wav[:, None, :].to(self.dtype), 7)
        i = 1
        for r in reversed(ratios):
            x = self.resblock(f"encoder.model.{i}", x)
            x = self.sconv(f"encoder.model.{i + 2}.conv.conv", F.elu(x), 2 * r, stride=r)
            i += 3
        x = self.slstm(f"encoder.model.{i}", x)
        return self.sconv(f"encoder.model.{i + 2}.conv.conv", F.elu(x), 7)

    def decoder(self, z: torch.Tensor) -> torch.Tensor:
        """latents ``[B, D, frames]`` -> wav ``[B, T]``."""
        x = self.sconv("decoder.model.0.conv.conv", z, 7)
        x = self.slstm("decoder.model.1", x)
        i = 2
        for r in self.cfg["ratios"]:
            x = self.sconvtr(f"decoder.model.{i + 1}.convtr.convtr", F.elu(x), 2 * r, r)
            x = self.resblock(f"decoder.model.{i + 2}", x)
            i += 3
        return self.sconv(f"decoder.model.{i + 1}.conv.conv", F.elu(x), 7)[:, 0]

    # ---------------------------------------------------------------- quantizer
    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> codes ``[n_q, B, frames]``: the nearest row of each
        codebook to the residual, lowest index on ties."""
        z = self.encoder(wav)
        B, D, T = z.shape
        r = z.transpose(1, 2).reshape(B * T, D)
        codes = []
        for book in self.books:
            idx = nearest(r, book)
            codes.append(idx)
            r = r - book[idx]
        return torch.stack(codes).reshape(-1, B, T)

    def latents(self, wav: torch.Tensor) -> torch.Tensor:
        """The encoder's frames ``[B * frames, D]``, as the codebook search sees them."""
        z = self.encoder(wav)
        return z.transpose(1, 2).reshape(-1, z.shape[1])

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> wav ``[B, T]``."""
        codes = codes.long()
        q = sum(self.books[i][codes[i]] for i in range(codes.shape[0]))  # [B, frames, D]
        return self.decoder(q.transpose(1, 2))

    def books_for_search(self) -> List[torch.Tensor]:
        """The codebooks in search order, each ``[groups = 1, K, D]``."""
        return [b[None] for b in self.books]


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect padding that first zero-extends a signal no longer than the pad."""
    length = x.shape[-1]
    extra = max(0, max(left, right) - length + 1)
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra]


def nearest(r: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """Row of ``book [K, D]`` nearest each row of ``r [N, D]`` (lowest index on ties)."""
    dist = r.square().sum(1, keepdim=True) - 2.0 * r @ book.t() + book.square().sum(1)
    return dist.argmin(dim=1)
