"""Plain PyTorch reference of HiFi-Codec (VQVAE: HiFi-GAN encoder -> GRVQ -> HiFi-GAN generator).

Written from the reference recipe's description (AcademiCodec
``models/hificodec/models.py`` and ``vqvae.py``): the encoder mirrors the
generator, with strided convs and, after each of a stage's three
``ResBlock1`` towers, a GroupNorm of the accumulated sum (``ch // 16``
groups, eps 1e-6); the quantizer splits each latent frame into groups, each
with its own codebook, over two residual layers; the generator upsamples by
conv-transposes and averages three resblock towers a stage. Every tensor
is f32 (or the ``dtype`` asked for) and unpadded: a clip is encoded at its own length. Parameters come
from the three reference ``state_dict`` parts (``encoder.``, ``generator.``,
``quantizer.`` prefixes); :func:`param_specs` lists them.

The slope of the leaky ReLU in front of the generator's ``conv_post`` is
the configuration's ``generator_post_slope`` (see the configuration file).

The module imports torch alone: nothing of the measured package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Specs = Dict[str, Tuple[Tuple[int, ...], str, int]]
Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]
SLOPE = 0.1  # the resblocks' and upsampling stages' leaky ReLU
GN_EPS = 1e-6


def latent_dim(cfg: dict) -> int:
    return cfg["encoder_base_channels"] * 2 ** len(cfg["upsample_rates"])


def _conv(specs: Specs, name: str, cin: int, cout: int, k: int, transpose: bool = False,
          weight_norm: bool = True) -> None:
    shape = (cin, cout, k) if transpose else (cout, cin, k)
    fan_in = (cout if transpose else cin) * k
    if weight_norm:
        specs[f"{name}.weight_v"] = (shape, "uniform", fan_in)
        specs[f"{name}.weight_g"] = ((shape[0], 1, 1), "norm_of_v", fan_in)
    else:
        specs[f"{name}.weight"] = (shape, "uniform", fan_in)
    specs[f"{name}.bias"] = ((cout,), "uniform", fan_in)


def _resblock(specs: Specs, name: str, ch: int, k: int, dilations) -> None:
    for j in range(len(dilations)):
        _conv(specs, f"{name}.convs1.{j}", ch, ch, k)
    for j in range(len(dilations)):
        _conv(specs, f"{name}.convs2.{j}", ch, ch, k)


def param_specs(cfg: dict) -> Specs:
    """Every parameter of the encoder, generator and quantizer, prefixed by part,
    every conv drawn as torch's default uniform init. (The recipe's
    ``init_weights`` draws the strided, upsampling and post convs N(0, 0.01^2):
    its untrained generator then puts out a constant offset with a signal
    some 1e-3 of it, below bf16's resolution, so no check could tell
    precisions apart on the decoded wav.)"""
    base, rates, kernels = cfg["encoder_base_channels"], cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
    rks, rds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
    D = latent_dim(cfg)
    specs: Specs = {}
    _conv(specs, "encoder.conv_pre", 1, base, 7)
    n = 0
    for i, (u, k) in enumerate(reversed(list(zip(rates, kernels)))):
        ch = base * 2 ** (i + 1)
        _conv(specs, f"encoder.ups.{i}", base * 2 ** i, ch, k)
        for j in range(len(rks)):
            _resblock(specs, f"encoder.resblocks.{n}", ch, rks[::-1][j], rds[::-1][j])
            specs[f"encoder.normalize.{n}.weight"] = ((ch,), "ones", 0)
            specs[f"encoder.normalize.{n}.bias"] = ((ch,), "zeros", 0)
            n += 1
    _conv(specs, "encoder.conv_post", D, D, 3, weight_norm=False)
    c0 = cfg["upsample_initial_channel"]
    _conv(specs, "generator.conv_pre", D, c0, 7)
    n = 0
    for i, (u, k) in enumerate(zip(rates, kernels)):
        cout = c0 // 2 ** (i + 1)
        _conv(specs, f"generator.ups.{i}", c0 // 2 ** i, cout, k, transpose=True)
        for j in range(len(rks)):
            _resblock(specs, f"generator.resblocks.{n}", cout, rks[j], rds[j])
            n += 1
    _conv(specs, "generator.conv_post", c0 // 2 ** len(rates), 1, 7)
    G = cfg["n_code_groups"]
    for layer, prefix in enumerate(("quantizer_modules", "quantizer_modules2")):
        for g in range(G):
            specs[f"quantizer.{prefix}.{g}.embedding.weight"] = ((cfg["n_codes"], D // G), "codebook", 0)
    return specs


def _same(cast: Cast, t: torch.Tensor) -> torch.Tensor:
    return t if cast is None else cast(t)


class HiFiCodecReference:
    """The VQVAE's forward in plain f32 PyTorch over a reference ``state_dict``."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], cast: Cast = None,
                 dtype: torch.dtype = torch.float32):
        self.cfg, self.cast, self.dtype = cfg, cast, dtype
        self.sd = {k: v.to(dtype) for k, v in sd.items()}
        G = cfg["n_code_groups"]
        self.books = torch.stack([  # [layers, G, K, D / G]
            torch.stack([self.sd[f"quantizer.{p}.{g}.embedding.weight"] for g in range(G)])
            for p in ("quantizer_modules", "quantizer_modules2")
        ])

    def _weight(self, name: str) -> torch.Tensor:
        if f"{name}.weight" in self.sd:
            return self.sd[f"{name}.weight"]
        v, g = self.sd[f"{name}.weight_v"], self.sd[f"{name}.weight_g"]
        return g * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt()

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, dilation: int = 1, padding: int = 0):
        c = self.cast
        return F.conv1d(_same(c, x), _same(c, self._weight(name)), self.sd[f"{name}.bias"], stride=stride,
                        dilation=dilation, padding=padding)

    def convtr(self, name: str, x: torch.Tensor, stride: int, padding: int):
        c = self.cast
        return F.conv_transpose1d(_same(c, x), _same(c, self._weight(name)), self.sd[f"{name}.bias"],
                                  stride=stride, padding=padding)

    def resblock(self, name: str, x: torch.Tensor, k: int, dilations) -> torch.Tensor:
        """ResBlock1: per dilation, lrelu -> dilated conv -> lrelu -> conv, plus the input."""
        for j, d in enumerate(dilations):
            xt = self.conv(f"{name}.convs1.{j}", F.leaky_relu(x, SLOPE), dilation=d, padding=(k * d - d) // 2)
            xt = self.conv(f"{name}.convs2.{j}", F.leaky_relu(xt, SLOPE), padding=(k - 1) // 2)
            x = xt + x
        return x

    def group_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        xg = x.reshape(B, C // 16, -1)
        mean = xg.mean(dim=2, keepdim=True)
        var = (xg - mean).square().mean(dim=2, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + GN_EPS)).reshape(B, C, T)
        return y * self.sd[f"{name}.weight"][:, None] + self.sd[f"{name}.bias"][:, None]

    def encoder(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> latents ``[B, D, frames]``."""
        cfg = self.cfg
        rks, rds = cfg["resblock_kernel_sizes"][::-1], cfg["resblock_dilation_sizes"][::-1]
        x = self.conv("encoder.conv_pre", wav[:, None, :].to(self.dtype), padding=3)
        n = 0
        for i, (u, k) in enumerate(reversed(list(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])))):
            x = self.conv(f"encoder.ups.{i}", F.leaky_relu(x, SLOPE), stride=u, padding=(k - u) // 2)
            xs = None
            for j in range(len(rks)):
                r = self.resblock(f"encoder.resblocks.{n}", x, rks[j], rds[j])
                xs = self.group_norm(f"encoder.normalize.{n}", r if xs is None else xs + r)
                n += 1
            x = xs / len(rks)
        return self.conv("encoder.conv_post", F.leaky_relu(x, 0.01), padding=1)

    def generator(self, z: torch.Tensor) -> torch.Tensor:
        """latents ``[B, D, frames]`` -> wav ``[B, T]``."""
        cfg = self.cfg
        rks, rds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
        x = self.conv("generator.conv_pre", z, padding=3)
        n = 0
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
            x = self.convtr(f"generator.ups.{i}", F.leaky_relu(x, SLOPE), stride=u, padding=(k - u) // 2)
            xs = None
            for j in range(len(rks)):
                r = self.resblock(f"generator.resblocks.{n}", x, rks[j], rds[j])
                xs = r if xs is None else xs + r
                n += 1
            x = xs / len(rks)
        x = self.conv("generator.conv_post", F.leaky_relu(x, cfg["generator_post_slope"]), padding=3)
        return torch.tanh(x)[:, 0]

    def latents(self, wav: torch.Tensor) -> torch.Tensor:
        """The encoder's frames ``[B * frames, D]``, as the codebook search sees them."""
        z = self.encoder(wav)
        return z.transpose(1, 2).reshape(-1, z.shape[1])

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """wav ``[B, T]`` -> tokens ``[B, frames, layers * G]``, order ``[l0 g0, l0 g1, l1 g0, l1 g1]``."""
        z = self.encoder(wav)
        B, D, T = z.shape
        L, G, K, d = self.books.shape
        r = z.transpose(1, 2).reshape(B * T, G, d)
        codes = []
        for layer in self.books:
            idx = torch.stack([nearest(r[:, g], layer[g]) for g in range(G)], dim=1)
            r = r - torch.stack([layer[g][idx[:, g]] for g in range(G)], dim=1)
            codes.append(idx)
        return torch.cat(codes, dim=1).reshape(B, T, L * G)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """tokens ``[B, frames, layers * G]`` -> wav ``[B, T]``."""
        codes = codes.long()
        L, G, K, d = self.books.shape
        parts = [torch.cat([self.books[i, g][codes[..., i * G + g]] for g in range(G)], dim=-1) for i in range(L)]
        return self.generator(sum(parts).transpose(1, 2))

    def books_for_search(self) -> List[torch.Tensor]:
        """The codebooks in token order, each ``[G, K, D / G]``."""
        return list(self.books)

    def frames_for(self, n: int) -> int:
        """Latent frames of a clip of ``n`` samples: each strided conv's output length."""
        cfg = self.cfg
        for u, k in reversed(list(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]))):
            n = (n + 2 * ((k - u) // 2) - k) // u + 1
        return n


def nearest(r: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    dist = r.square().sum(1, keepdim=True) - 2.0 * r @ book.t() + book.square().sum(1)
    return dist.argmin(dim=1)
