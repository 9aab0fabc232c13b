"""HiFi-GAN encoder and generator (the HiFi-Codec backbone) on ``[B, C, T]``.

Submodule names follow the reference module tree (``conv_pre``, ``ups.{i}``,
``resblocks.{i}.convs1.{j}``, ``normalize.{i}``, ``conv_post``), so the
reference ``g_*`` state dicts load with ``load_state_dict``.

Stages with at most ``FUSED_MAX_CHANNELS`` channels run their resblock towers
through ``ops/cuda/resblock``: the encoder's bundle through K4
(``resblock_tower_gn``), the generator's through K3 (``resblock_tower``,
with conv_post and tanh fused into the last stage). The wrappers launch the
kernels for CUDA tensors and run their plain versions for CPU tensors.
Wider stages run the plain chain of convs. Each fused stage keeps its packed
operands (:class:`PackedStage`) and rebuilds them, weight norm included,
only when a parameter changed.

Behavioral parity target: academicodec_tpu/nn/hifigan.py:40-722, non-causal,
without the length-masked encode (reference models/hificodec/models.py:
18-189, 364-427, including the GroupNorm of the accumulated sum at
models.py:410-415).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from academicodec_tpu_torch.ops.cuda.resblock import (
    PackedTower,
    pack_tower,
    resblock_tower,
    resblock_tower_gn,
)

LRELU_SLOPE = 0.1
# stages this narrow take the fused towers: the JAX package's default
# fused_max_channels (academicodec_tpu/nn/hifigan.py:307,510)
FUSED_MAX_CHANNELS = 64


def _lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return int((kernel_size * dilation - dilation) / 2)


@dataclass(frozen=True)
class HiFiCodecConfig:
    """The reference JSON config (egs/HiFi-Codec-*/config_*.json) as a dataclass."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 8, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    encoder_base_channels: int = 32  # reference hardcodes 32 (models.py:395)
    n_code_groups: int = 2
    n_codes: int = 1024
    codebook_loss_lambda: float = 1.0
    commitment_loss_lambda: float = 0.25
    sampling_rate: int = 24000
    segment_size: int = 16000
    num_mels: int = 80
    n_fft: int = 1024
    hop_size: int = 240
    win_size: int = 1024
    fmin: int = 0
    fmax: int = 8000
    fmax_for_loss: Any = None
    causal: bool = False  # the causal generator is not ported yet

    @property
    def latent_dim(self) -> int:
        """Encoder output width: base * 2^num_stages (512 at reference defaults)."""
        return self.encoder_base_channels * (2 ** len(self.upsample_rates))

    @classmethod
    def from_json(cls, d: dict) -> "HiFiCodecConfig":
        names = set(cls.__dataclass_fields__)
        kw = {}
        for k, v in d.items():
            if k in names:
                if isinstance(v, list):
                    v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
                kw[k] = v
        return cls(**kw)


def _res_conv(channels: int, kernel_size: int, dilation: int, norm: str) -> Conv1d:
    return Conv1d(channels, channels, kernel_size, dilation=dilation,
                  padding=get_padding(kernel_size, dilation), norm=norm)


class ResBlock1(nn.Module):
    """3x [lrelu -> dilated conv -> lrelu -> unit conv] with residual adds."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5),
                 norm: str = "weight_norm"):
        super().__init__()
        self.convs1 = nn.ModuleList(_res_conv(channels, kernel_size, d, norm) for d in dilation)
        self.convs2 = nn.ModuleList(_res_conv(channels, kernel_size, 1, norm) for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(_lrelu(c1(_lrelu(x)))) + x
        return x

    def weights_and_biases(self):
        """Resolved ``(weights, biases)`` in call order convs1.0, convs2.0,
        convs1.1, ...: what the fused towers take."""
        convs = [c for pair in zip(self.convs1, self.convs2) for c in pair]
        return tuple(c.resolved_weight() for c in convs), tuple(c.bias for c in convs)


class ResBlock2(nn.Module):
    """2x [lrelu -> dilated conv] with residual adds."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3),
                 norm: str = "weight_norm"):
        super().__init__()
        self.convs = nn.ModuleList(_res_conv(channels, kernel_size, d, norm) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(_lrelu(x)) + x
        return x

    def weights_and_biases(self):
        """Resolved ``(weights, biases)`` in call order convs.0, convs.1, ..."""
        return tuple(c.resolved_weight() for c in self.convs), tuple(c.bias for c in self.convs)


class GroupNormTorch(nn.Module):
    """GroupNorm with torch semantics: statistics over (channels of a group, time)."""

    def __init__(self, num_groups: int, channels: int, epsilon: float = 1e-6):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        xg = x.reshape(B, self.num_groups, C // self.num_groups, T)
        mean = xg.mean(dim=(2, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(2, 3), keepdim=True)
        xg = (xg - mean) * torch.rsqrt(var + self.epsilon)
        return xg.reshape(B, C, T) * self.weight[:, None] + self.bias[:, None]


class PackedStage:
    """The packed operands of one fused stage (:func:`pack_tower`), rebuilt
    when a parameter of its convs was updated in place, replaced, cast or
    moved. With gradients enabled nothing is kept: every call packs the
    current weights, so the plain versions stay differentiable."""

    def __init__(self):
        self.key, self.packed = None, None

    def get(self, blocks, kernel_sizes, dilation_sizes, resblock: str, post=None) -> PackedTower:
        def build():
            ws, bs = zip(*(rb.weights_and_biases() for rb in blocks))
            kw = {} if post is None else dict(post_weight=post.resolved_weight(), post_bias=post.bias)
            return pack_tower(ws, bs, kernel_sizes=kernel_sizes, dilation_sizes=dilation_sizes,
                              resblock=resblock, **kw)

        if torch.is_grad_enabled():
            return build()
        params = [p for rb in blocks for p in rb.parameters()]
        if post is not None:
            params += list(post.parameters())
        key = tuple((p._version, p.dtype, p.device, p.data_ptr()) for p in params)
        if key != self.key:
            self.key, self.packed = key, build()
        return self.packed


def _resblock_cls(h: HiFiCodecConfig):
    return ResBlock1 if h.resblock == "1" else ResBlock2


class HiFiGANEncoder(nn.Module):
    """The mirrored generator used as the HiFi-Codec encoder:
    ``[B, 1, T]`` -> ``[B, latent_dim, frames]``."""

    def __init__(self, config: HiFiCodecConfig, norm: str = "weight_norm"):
        super().__init__()
        h = self.config = config
        base = h.encoder_base_channels
        self.ups_cfg = list(reversed(list(zip(h.upsample_rates, h.upsample_kernel_sizes))))
        self.rks = tuple(reversed(h.resblock_kernel_sizes))
        self.rds = tuple(tuple(d) for d in reversed(h.resblock_dilation_sizes))
        nk = len(self.rks)
        self.conv_pre = Conv1d(1, base, 7, padding=3, norm=norm)
        ups, resblocks, norms = [], [], []
        for i, (u, k) in enumerate(self.ups_cfg):
            ch = base * 2 ** (i + 1)
            if ch < 16:
                raise ValueError(
                    f"encoder_base_channels={base} too small: stage {i} has {ch} channels "
                    "but GroupNorm uses ch//16 groups (reference models.py:412)"
                )
            ups.append(Conv1d(base * 2 ** i, ch, k, stride=u, padding=(k - u) // 2, norm=norm))
            for j in range(nk):
                resblocks.append(_resblock_cls(h)(ch, self.rks[j], self.rds[j], norm=norm))
                norms.append(GroupNormTorch(ch // 16, ch, epsilon=1e-6))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.normalize = nn.ModuleList(norms)
        self.conv_post = Conv1d(h.latent_dim, h.latent_dim, 3, padding=1, norm="none")
        self._packed = [PackedStage() for _ in self.ups_cfg]

    def normal_init_convs(self):
        """The convs the JAX package draws from N(0, 0.01^2) (nn/hifigan.py:35-37)."""
        return [*self.ups, self.conv_post]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nk = len(self.rks)
        x = self.conv_pre(x)
        for i, ups in enumerate(self.ups):
            x = ups(_lrelu(x))
            ch = x.shape[1]
            blocks = self.resblocks[i * nk:(i + 1) * nk]
            norms = self.normalize[i * nk:(i + 1) * nk]
            if ch <= FUSED_MAX_CHANNELS:
                packed = self._packed[i].get(blocks, self.rks, self.rds, self.config.resblock)
                x = resblock_tower_gn(
                    x, packed, None,
                    torch.stack([n.weight for n in norms]), torch.stack([n.bias for n in norms]),
                    num_groups=ch // 16, epsilon=1e-6,
                )
                continue
            xs = None
            for rb, gn in zip(blocks, norms):
                r = rb(x)
                # the reference normalizes the accumulated sum (models.py:410-415)
                xs = gn(r if xs is None else xs + r)
            x = xs / nk
        return self.conv_post(_lrelu(x, 0.01))  # default torch slope (models.py:417)


class HiFiGANGenerator(nn.Module):
    """HiFi-GAN generator: ``[B, latent_dim, frames]`` -> ``[B, 1, T]``."""

    def __init__(self, config: HiFiCodecConfig, norm: str = "weight_norm"):
        super().__init__()
        h = self.config = config
        nk = len(h.resblock_kernel_sizes)
        self.conv_pre = Conv1d(h.latent_dim, h.upsample_initial_channel, 7, padding=3, norm=norm)
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            cin = h.upsample_initial_channel // 2 ** i
            cout = h.upsample_initial_channel // 2 ** (i + 1)
            ups.append(ConvTranspose1d(cin, cout, k, stride=u, padding=(k - u) // 2, norm=norm))
            for j in range(nk):
                resblocks.append(_resblock_cls(h)(cout, h.resblock_kernel_sizes[j],
                                                  h.resblock_dilation_sizes[j], norm=norm))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = Conv1d(h.upsample_initial_channel // 2 ** len(ups), 1, 7, padding=3, norm=norm)
        self._packed = [PackedStage() for _ in ups]

    def normal_init_convs(self):
        """The convs the JAX package draws from N(0, 0.01^2) (nn/hifigan.py:35-37)."""
        return [*self.ups, self.conv_post]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.config
        nk = len(h.resblock_kernel_sizes)
        ks = tuple(h.resblock_kernel_sizes)
        dss = tuple(tuple(d) for d in h.resblock_dilation_sizes)
        x = self.conv_pre(x)
        n_up = len(self.ups)
        for i, ups in enumerate(self.ups):
            # lrelu and the upsampling convT stay PyTorch ops even on fused
            # stages: the JAX default fused_pre=False (nn/hifigan.py:512-517)
            x = ups(_lrelu(x))
            blocks = self.resblocks[i * nk:(i + 1) * nk]
            if x.shape[1] <= FUSED_MAX_CHANNELS:
                # conv_post and tanh run inside the last tower
                post = self.conv_post if i == n_up - 1 else None
                packed = self._packed[i].get(blocks, ks, dss, h.resblock, post)
                x = resblock_tower(x, packed, post_tanh=post is not None)
                if post is not None:
                    return x
                continue
            xs = None
            for rb in blocks:
                r = rb(x)
                xs = r if xs is None else xs + r
            x = xs / nk
        return torch.tanh(self.conv_post(_lrelu(x)))
