"""HiFi-Codec: HiFi-GAN encoder -> GRVQ -> HiFi-GAN generator, serving only.

``encode(wav [B, T]) -> tokens [B, frames, 4]`` (the VALL-E/SoundStorm
hand-off, stream order ``[l0 g0, l0 g1, l1 g0, l1 g1]``) and
``decode(tokens) -> wav [B, T]``. The model lives on one explicit device,
``cuda`` unless the caller asks for ``cpu``. On the card the encoder's
narrow stage runs K4 and, in a non-causal model, the generator's two narrow
stages run K3. A causal config (``HiFiCodecConfig(causal=True)``) also
decodes a stream chunk by chunk (``decode_stream``), with the state kept by
the caller.

``encode(x, lengths)`` is the length-masked encode of a zero-padded batch
of files of different lengths (K4 takes the lengths on the card): each row's
valid token frames equal its exact-length encode. ``generator.fused_pre =
True`` fuses each narrow stage's upsampling conv-transpose into K3, as the
JAX generator's option of that name does.

Behavioral parity target: academicodec_tpu/models/hificodec.py:23-110
(reference models/hificodec/vqvae.py:12-45).
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch
import torch.nn as nn

from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig, HiFiGANEncoder, HiFiGANGenerator
from academicodec_tpu_torch.quant.grvq import GroupResidualVQ

# std of the N(0, std^2) init of the convs the JAX package draws with
# hifigan_normal_init (reference utils.py:181-184)
HIFIGAN_INIT_STD = 0.01


def _strip_ddp(sd: Mapping[str, torch.Tensor]) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


class VQVAE(nn.Module):
    def __init__(
        self,
        config: HiFiCodecConfig = HiFiCodecConfig(),
        norm: str = "weight_norm",
        *,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        """Builds the model with random weights drawn from ``seed`` on the CPU
        (identical on every device), then moves it to ``device`` and ``dtype``."""
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.encoder = HiFiGANEncoder(config, norm)
        self.generator = HiFiGANGenerator(config, norm)
        self.quantizer = GroupResidualVQ(
            dim=config.latent_dim, n_codes=config.n_codes, n_groups=config.n_code_groups, n_residual=2
        )
        generator = torch.Generator().manual_seed(seed)
        normal = {id(c) for c in self.encoder.normal_init_convs() + self.generator.normal_init_convs()}
        for m in self.modules():
            if isinstance(m, (Conv1d, ConvTranspose1d)):
                m.reset_parameters(generator, HIFIGAN_INIT_STD if id(m) in normal else None)
        self.quantizer.reset_parameters(generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.quantizer.codebooks.device

    @property
    def dtype(self) -> torch.dtype:
        return self.quantizer.codebooks.dtype

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.config.upsample_rates))

    def load_reference(self, ckpt: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Load a reference ``g_*`` checkpoint ``{'generator', 'encoder',
        'quantizer'}`` (DDP ``module.`` prefixes removed)."""
        for part in ("encoder", "generator", "quantizer"):
            getattr(self, part).load_state_dict(_strip_ddp(ckpt[part]))

    @torch.no_grad()
    def encode(self, x, lengths=None) -> torch.Tensor:
        """wav ``[B, T]`` -> tokens ``[B, frames, n_res * G]`` int32 (reference
        vqvae.py:37-45). ``lengths [B]``: the valid samples of each row of a
        zero-padded batch; each row's first ``frames_for(lengths[b])`` token
        frames are then those of its exact-length encode (JAX
        models/hificodec.py:84-97); the caller trims the rest."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        c = self.encoder(x[:, None, :], lengths)
        return self.quantizer.encode(c.transpose(1, 2))

    def frames_for(self, n_samples: int) -> int:
        """Token frames of an exact-length encode of ``n_samples`` samples: each
        encoder stage's strided-conv output length."""
        n = n_samples
        for u, k in self.encoder.ups_cfg:
            n = (n + 2 * ((k - u) // 2) - k) // u + 1
        return n

    @torch.no_grad()
    def decode(self, codes) -> torch.Tensor:
        """tokens ``[B, frames, n_res * G]`` -> wav ``[B, T]`` (reference vqvae.py:31-35)."""
        codes = torch.as_tensor(codes).to(device=self.device)
        q = self.quantizer.embed(codes)
        return self.generator(q.transpose(1, 2).contiguous())[:, 0, :]

    @torch.no_grad()
    def decode_stream(self, codes, state=None):
        """One chunk of tokens ``[B, frames, n_res * G]`` and the generator state
        the last chunk left (None starts a stream) -> ``(wav [B, frames * hop],
        next state)``; causal configs only (JAX models/hificodec.py:104-110)."""
        codes = torch.as_tensor(codes).to(device=self.device)
        q = self.quantizer.embed(codes)
        y, state = self.generator.stream(q.transpose(1, 2).contiguous(), state)
        return y[:, 0, :], state
