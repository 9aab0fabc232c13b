"""The Descript Audio Codec (DAC), served over whole clips.

Encode: the clip zero-padded on the right to a multiple of the hop ->
the Snake-activated encoder (``nn/dac.py``: a 7-tap conv to ``encoder_dim``
channels, one block a stride doubling them, a Snake and a 3-tap conv to the
latent) -> the factorized, L2-normalized RVQ (``quant/fvq.py``). Decode: the
layers' projected rows summed -> the decoder (a 7-tap conv to
``decoder_dim`` channels, one block a rate halving them, a Snake, a 7-tap
conv to one channel, tanh). The numbers of the 44.1 kHz model are HF
``descript/dac_44khz`` ``config.json``'s (``DacConfig``) and
descript-audio-codec's ``conf/final/44khz.yml``: encoder 64 channels at
strides (2, 4, 8, 8), hop 512 (86.13 frames a second), a 1024-wide latent,
decoder 1536 channels at rates (8, 8, 4, 2), 9 codebooks of 1024 x 8.

Public layouts are SoundStream's: wav ``[B, T]``, codes ``[n_q, B, frames]``
int32 with ``frames = ceil(T / 512)``, and ``decode`` gives ``frames x 512``
samples. Served at every codebook unless ``n_q`` says fewer. Not served:
the length-masked ``encode(wav, lengths=)`` and streaming, which raise.

Precision: the towers run in the model's dtype (channels-last on the card in
16-bit, ``nn/dac.py``); the Snake alphas, the biases that the epilogues add
and the whole quantizer stay f32, and the epilogues compute in f32.

Spans (``utils/profiling.py``) as Mimi's: the roots ``codec.encode`` /
``codec.decode``, then ``codec.upload``, ``codec.encoder``,
``codec.quantize``, ``codec.dequantize``, ``codec.decoder``, with one
``codec.snake`` around each epilogue inside the encoder and decoder.

State-dict keys are DAC's own (``encoder.block...``, ``decoder.model...``,
``quantizer.quantizers.{i}...``), codebooks as plain tables.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from academicodec_tpu_torch.nn.dac import (
    Decoder, Encoder, Snake1d, channels_last_towers, epilogue_convs, wav_channels_last,
)
from academicodec_tpu_torch.quant.fvq import FactorizedRVQ
from academicodec_tpu_torch.utils import profiling


class DAC(nn.Module):
    def __init__(
        self,
        encoder_dim: int = 64,
        encoder_rates: Tuple[int, ...] = (2, 4, 8, 8),
        latent_dim: int = 1024,
        decoder_dim: int = 1536,
        decoder_rates: Tuple[int, ...] = (8, 8, 4, 2),
        n_codebooks: int = 9,
        codebook_size: int = 1024,
        codebook_dim: int = 8,
        sample_rate: int = 44100,
        *,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        """Builds the model with random weights drawn from ``seed`` on the CPU
        (torch's uniform init, every Snake alpha at DAC's init 1, N(0, 1)
        codebooks; identical on every device), then moves it to ``device`` and
        ``dtype``, keeping the f32 parts f32 (module docstring)."""
        super().__init__()
        device = resolve_device(device)
        self.encoder_rates, self.decoder_rates = tuple(encoder_rates), tuple(decoder_rates)
        self.sample_rate = sample_rate
        self.hop_length = math.prod(self.encoder_rates)
        self.frame_rate = sample_rate / self.hop_length
        self.encoder = Encoder(encoder_dim, self.encoder_rates, latent_dim)
        self.quantizer = FactorizedRVQ(latent_dim, n_codebooks, codebook_size, codebook_dim)
        self.decoder = Decoder(latent_dim, decoder_dim, self.decoder_rates)
        generator = torch.Generator().manual_seed(seed)
        for m in (*self.encoder.modules(), *self.decoder.modules()):
            if isinstance(m, (Conv1d, ConvTranspose1d)):
                m.reset_parameters(generator)
        self.quantizer.reset_parameters(generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    def _apply(self, fn, recurse=True):
        """``to`` / ``half`` / ...: the Snake alphas, the epilogues' biases and the
        quantizer keep f32 whatever the towers' dtype."""
        super()._apply(fn, recurse)
        keep = [m.alpha for m in self.modules() if isinstance(m, Snake1d)]
        keep += [m.bias for m in epilogue_convs(self)] + list(self.quantizer.parameters())
        for p in keep:
            if p.dtype != torch.float32:
                p.data = p.data.float()
        return self

    @property
    def device(self) -> torch.device:
        return self.encoder.block[0].weight_v.device

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.block[0].weight_v.dtype

    @property
    def n_q(self) -> int:
        return self.quantizer.n_q

    def frames_for(self, samples: int) -> int:
        """Codes frames of a clip of ``samples``."""
        return -(-samples // self.hop_length)

    @torch.no_grad()
    @profiling.span("codec.encode")
    def encode(self, x, n_q: Optional[int] = None, lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """wav ``[B, T]`` -> codes ``[n_q, B, ceil(T / 512)]`` int32 (all codebooks for None)."""
        if lengths is not None:
            raise NotImplementedError("DAC's length-masked encode(wav, lengths=) is not implemented: encode "
                                      "each clip at its own length")
        with profiling.span("codec.upload"):
            x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        B, T = x.shape
        frames = self.frames_for(T)
        with profiling.span("codec.encoder"):
            x = F.pad(x, (0, frames * self.hop_length - T))
            z = self.encoder(wav_channels_last(x) if channels_last_towers(x) else x[:, None, :])
        with profiling.span("codec.quantize"):
            rows = z.squeeze(2).transpose(1, 2).reshape(B * frames, -1) if z.dim() == 4 else \
                z.transpose(1, 2).reshape(B * frames, -1)
            return self.quantizer.encode(rows, n_q).view(-1, B, frames)

    @torch.no_grad()
    @profiling.span("codec.decode")
    def decode(self, codes) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> wav ``[B, frames * 512]``."""
        with profiling.span("codec.upload"):
            codes = torch.as_tensor(codes).to(device=self.device)
        n, B, frames = codes.shape
        with profiling.span("codec.dequantize"):
            q = self.quantizer.decode(codes.reshape(n, B * frames)).to(self.dtype).view(B, frames, -1)
        with profiling.span("codec.decoder"):
            if channels_last_towers(q):
                q = q.transpose(1, 2).unsqueeze(2)  # [B, C, 1, frames], each frame's channels contiguous
            else:
                q = q.transpose(1, 2).contiguous()
            return self.decoder(q).reshape(B, -1)

    def encode_stream(self, *args, **kwargs):
        raise NotImplementedError("DAC is served over whole clips here: streaming encode is not implemented")

    def decode_stream(self, *args, **kwargs):
        raise NotImplementedError("DAC is served over whole clips here: streaming decode is not implemented")
