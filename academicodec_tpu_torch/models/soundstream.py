"""SoundStream / Encodec generator: SEANet encoder -> RVQ -> SEANet decoder.

Public layouts match the JAX package: wav ``[B, T]``, codes
``[n_q, B, frames]``. The model lives on one explicit device, ``cuda``
unless the caller asks for ``cpu``; ``encode``/``decode`` move their input
there. On the card every kernel of the path runs: the fused RVQ search in
``encode`` (for any ``st``) and the fused LSTM in both towers.

Causal models also stream (``encode_stream`` / ``decode_stream``): one
chunk at a time, with the towers' state passed in and given back by the
caller (``streaming.py`` keeps it per session), so that the model itself
holds no state of a stream.

Behavioral parity target: academicodec_tpu/models/soundstream.py:26-131
(reference models/encodec/net3.py:12-61).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from academicodec_tpu_torch.nn.lstm import LSTMParams
from academicodec_tpu_torch.nn.seanet import SEANetDecoder, SEANetEncoder
from academicodec_tpu_torch.quant.core_vq import ResidualVQ
from academicodec_tpu_torch.quant.vq import ResidualVectorQuantizer


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; a CUDA request without a card raises instead of
    running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class SoundStream(nn.Module):
    def __init__(
        self,
        n_filters: int = 32,
        dimension: int = 512,
        ratios: Tuple[int, ...] = (8, 5, 4, 2),
        sample_rate: int = 24000,
        target_bandwidths: Sequence[float] = (7.5, 15.0),
        bins: int = 1024,
        causal: bool = False,
        pad_mode: str = "reflect",
        norm: str = "weight_norm",
        lstm: int = 2,
        *,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        """Builds the model with random weights drawn from ``seed`` on the CPU
        (identical on every device), then moves it to ``device`` and ``dtype``.
        ``norm``: the SEANet convs' norm (``nn/conv.NORMS``); ``lstm``: the
        SLSTM's layer count, 0 for none (SEANet's own options, which the JAX
        SoundStream fixes at 2)."""
        super().__init__()
        device = resolve_device(device)
        self.ratios = tuple(ratios)
        self.sample_rate = sample_rate
        self.target_bandwidths = tuple(target_bandwidths)
        self.bins = bins
        self.causal = causal
        common = dict(
            n_filters=n_filters, dimension=dimension, ratios=self.ratios,
            causal=causal, pad_mode=pad_mode, norm=norm, lstm=lstm,
        )
        self.encoder = SEANetEncoder(**common)
        self.decoder = SEANetDecoder(**common)
        self.quantizer = ResidualVectorQuantizer(dimension=dimension, n_q=self.n_q, bins=bins)
        generator = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv1d, ConvTranspose1d, LSTMParams, ResidualVQ)):
                m.reset_parameters(generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.quantizer.vq.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.quantizer.vq.embed.dtype

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sample_rate / self.hop_length)

    @property
    def bits_per_codebook(self) -> int:
        return int(math.log2(self.bins))

    @property
    def n_q(self) -> int:
        # reference net3.py:25-26
        return int(1000 * self.target_bandwidths[-1] // (self.frame_rate * 10))

    def n_q_for_bandwidth(self, bw: Optional[float]) -> int:
        """The streams ``encode`` emits at bandwidth ``bw`` (all of them for None)."""
        return self.quantizer.get_num_quantizers_for_bandwidth(self.frame_rate, bw)

    def sample_n_q(self, generator: torch.Generator) -> int:
        """The layer count of a uniformly drawn target bandwidth (reference
        net3.py:40-41, JAX models/soundstream.py:72), drawn from ``generator``."""
        choices = [self.n_q_for_bandwidth(bw) for bw in self.target_bandwidths]
        return choices[int(torch.randint(len(choices), (), generator=generator))]

    def forward(self, x: torch.Tensor, n_q: Optional[int] = None, training: bool = False,
                draws: Optional[torch.Tensor] = None, group=None):
        """Training/eval forward, wav ``[B, T]`` on the model's device, in any float
        dtype the weights take -> ``(recon [B, T], commit loss, codes [n_q, B,
        frames])`` (JAX models/soundstream.py:99-111). ``training`` updates the
        codebooks' EMA state and needs ``draws`` (``quant/core_vq.py``). The 2-layer
        SLSTMs run K2 when autograd does not record the call, else the library LSTM.
        ``group``: the data-parallel process group of the codebooks' statistics
        (``quant/core_vq.py``); ``x`` is then this rank's rows."""
        e = self.encoder(x[:, None, :])
        quantized, codes, _bw, commit = self.quantizer(
            e.transpose(1, 2), self.frame_rate, n_q=n_q if n_q is not None else self.n_q,
            training=training, draws=draws, group=group,
        )
        return self.decoder(quantized.transpose(1, 2))[:, 0, :], commit, codes

    @torch.no_grad()
    def encode(self, x, target_bw: Optional[float] = None, st: int = 0) -> torch.Tensor:
        """wav ``[B, T]`` -> codes ``[n_q - st, B, frames]`` int32 (reference net3.py:47-56)."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        e = self.encoder(x[:, None, :])
        bw = target_bw if target_bw is not None else self.target_bandwidths[-1]
        return self.quantizer.encode(e.transpose(1, 2), self.frame_rate, bw, st=st)

    @torch.no_grad()
    def decode(self, codes) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> wav ``[B, T]`` (reference net3.py:58-61)."""
        codes = torch.as_tensor(codes).to(device=self.device)
        quantized = self.quantizer.decode(codes)
        return self.decoder(quantized.transpose(1, 2))[:, 0, :]

    @torch.no_grad()
    def encode_stream(self, x, state=None, target_bw: Optional[float] = None, st: int = 0):
        """One stream chunk, wav ``[B, chunk]`` (``chunk % hop_length == 0``), and the
        encoder state the last chunk left (None starts a stream) -> ``(codes
        [n_q - st, B, chunk / hop], next state)`` (JAX models/soundstream.py:133-142)."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        e, state = self.encoder.stream(x[:, None, :], state)
        bw = target_bw if target_bw is not None else self.target_bandwidths[-1]
        return self.quantizer.encode(e.transpose(1, 2), self.frame_rate, bw, st=st), state

    @torch.no_grad()
    def decode_stream(self, codes, state=None):
        """One chunk of codes ``[n, B, frames]`` and the decoder state -> ``(wav
        [B, frames * hop], next state)`` (JAX models/soundstream.py:144-150)."""
        codes = torch.as_tensor(codes).to(device=self.device)
        y, state = self.decoder.stream(self.quantizer.decode(codes).transpose(1, 2), state)
        return y[:, 0, :], state
