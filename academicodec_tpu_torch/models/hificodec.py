"""HiFi-Codec: HiFi-GAN encoder -> GRVQ -> HiFi-GAN generator.

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

``forward(x, training)`` is the trainer's forward (``train/hificodec.py``):
wav ``[B, T]`` -> ``(wav [B, T], loss_q, codes)``, differentiable. Under
autograd the narrow stages run their unfused chains (K3/K4 have no backward,
and the JAX trainer runs them unfused too); without a gradient they launch
K3/K4 as in serving.

``VQVAE(int8_min_channels=N)`` serves the resblock convs of the unfused
stages of at least N channels as W8A8 int8 (``nn/hifigan.py``), once
:func:`calibrate_quant` has recorded their activation scales; the scales
of the JAX package's ``'quant'`` collection load with :meth:`VQVAE.load_quant`.

Each public call is a root span (``codec.encode`` / ``codec.decode``, a
stream chunk too) over the stages ``codec.upload``, ``codec.encoder``,
``codec.quantize``, ``codec.dequantize`` and ``codec.decoder``
(``utils/profiling.py``).

Behavioral parity target: academicodec_tpu/models/hificodec.py:23-135
(reference models/hificodec/vqvae.py:12-45).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig, HiFiGANEncoder, HiFiGANGenerator, strided_length
from academicodec_tpu_torch.quant.grvq import GroupResidualVQ
from academicodec_tpu_torch.utils import profiling

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
        int8_min_channels: int = 0,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        """Builds the model with random weights drawn from ``seed`` on the CPU
        (identical on every device), then moves it to ``device`` and ``dtype``.
        ``int8_min_channels`` > 0: W8A8 serving of the unfused stages that wide
        (the causal generator stays at full precision, as in JAX)."""
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.encoder = HiFiGANEncoder(config, norm, int8_min_channels=int8_min_channels)
        self.generator = HiFiGANGenerator(config, norm, int8_min_channels=0 if config.causal else int8_min_channels)
        self.quantizer = GroupResidualVQ(
            dim=config.latent_dim, n_codes=config.n_codes, n_groups=config.n_code_groups, n_residual=2,
            codebook_loss_lambda=config.codebook_loss_lambda, commitment_loss_lambda=config.commitment_loss_lambda,
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

    def reference_state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The reference ``g_*`` dict ``{'generator', 'encoder', 'quantizer'}``
        (what :meth:`load_reference` reads)."""
        return {part: getattr(self, part).state_dict() for part in ("generator", "encoder", "quantizer")}

    def forward(self, x: torch.Tensor, training: bool = False):
        """wav ``[B, T]`` -> ``(wav [B, T], loss_q, codes [B, frames, n_res * G])``
        (JAX models/hificodec.py:74-82), in the dtype of ``x`` and the weights."""
        with profiling.span("codec.encoder"):
            c = self.encoder(x[:, None, :])
        with profiling.span("codec.quantize"):
            q, loss_q, codes = self.quantizer(c.transpose(1, 2), training=training)
        with profiling.span("codec.decoder"):
            y = self.generator(q.transpose(1, 2))
        return y[:, 0, :], loss_q, codes

    def w8a8_convs(self) -> Dict[str, Conv1d]:
        """The int8 convs by module path (``encoder.resblocks.3.convs1.0``)."""
        return {name: m for name, m in self.named_modules() if isinstance(m, Conv1d) and m.w8a8}

    def load_quant(self, act_amax: Mapping[str, torch.Tensor]) -> None:
        """Set the int8 convs' activation scales from ``{module path: max |x|}``
        (``utils/convert.hificodec_quant_from_jax``); every int8 conv needs one."""
        convs = self.w8a8_convs()
        if set(act_amax) != set(convs):
            raise KeyError(f"act_amax for {sorted(act_amax)}, the model's int8 convs are {sorted(convs)}")
        for name, conv in convs.items():
            conv.act_amax = torch.as_tensor(act_amax[name], dtype=torch.float32).reshape(()).to(self.device)

    @torch.no_grad()
    @profiling.span("codec.encode")
    def encode(self, x, lengths=None) -> torch.Tensor:
        """wav ``[B, T]`` -> tokens ``[B, frames, n_res * G]`` int32 (reference
        vqvae.py:37-45). ``lengths [B]``: the valid samples of each row of a
        zero-padded batch; each row's first ``frames_for(lengths[b])`` token
        frames are then those of its exact-length encode (JAX
        models/hificodec.py:84-97); the caller trims the rest."""
        with profiling.span("codec.upload"):
            x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        with profiling.span("codec.encoder"):
            c = self.encoder(x[:, None, :], lengths)
        with profiling.span("codec.quantize"):
            return self.quantizer.encode(c.transpose(1, 2))

    def frames_for(self, n_samples: int) -> int:
        """Token frames of an exact-length encode of ``n_samples`` samples: each
        encoder stage's strided-conv output length."""
        n = n_samples
        for u, k in self.encoder.ups_cfg:
            n = strided_length(n, k, u)
        return n

    @torch.no_grad()
    @profiling.span("codec.decode")
    def decode(self, codes) -> torch.Tensor:
        """tokens ``[B, frames, n_res * G]`` -> wav ``[B, T]`` (reference vqvae.py:31-35)."""
        with profiling.span("codec.upload"):
            codes = torch.as_tensor(codes).to(device=self.device)
        with profiling.span("codec.dequantize"):
            q = self.quantizer.embed(codes)
        with profiling.span("codec.decoder"):
            return self.generator(q.transpose(1, 2))[:, 0, :]

    @torch.no_grad()
    @profiling.span("codec.decode")
    def decode_stream(self, codes, state=None):
        """One chunk of tokens ``[B, frames, n_res * G]`` and the generator state
        the last chunk left (None starts a stream) -> ``(wav [B, frames * hop],
        next state)``; causal configs only (JAX models/hificodec.py:104-110)."""
        with profiling.span("codec.upload"):
            codes = torch.as_tensor(codes).to(device=self.device)
        with profiling.span("codec.dequantize"):
            q = self.quantizer.embed(codes)
        with profiling.span("codec.decoder"):
            y, state = self.generator.stream(q.transpose(1, 2).contiguous(), state)
        return y[:, 0, :], state


@torch.no_grad()
def calibrate_quant(model: VQVAE, wav) -> VQVAE:
    """Record the activation scale of every int8 conv of ``model`` from one
    full-precision roundtrip (encode, then decode of its tokens) of ``wav
    [B, T]``: each conv keeps the max |input| it saw, across calls. Calibrate
    on representative audio, with the threshold used for serving; louder
    inputs clip at that max. Returns ``model`` (JAX models/hificodec.py:113-135)."""
    convs = model.w8a8_convs().values()
    if not convs:
        raise ValueError("the model has no int8 convs to calibrate (int8_min_channels=0 or all stages fused)")
    for conv in convs:
        conv.calibrating = True
    try:
        model.decode(model.encode(wav))
    finally:
        for conv in convs:
            conv.calibrating = False
    return model
