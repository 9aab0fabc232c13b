"""Mimi, the streaming codec of Kyutai's Moshi, served causally over whole clips.

Encode: a causal SEANet encoder (n_filters 64, ratios (8, 6, 5, 4): 25 Hz at
24 kHz) -> an 8-layer sliding-window transformer (``nn/transformer.py``) ->
a learnt 2x downsample (a causal conv, k 4, stride 2, replicate padding, no
bias) to 12.5 Hz -> a split RVQ of 1 + 31 codebooks of 2048 x 256
(``quant/vq.py``, two K1 searches). Decode: both parts' lookups and output
projections summed -> a learnt 2x upsample (a causal depthwise
conv-transpose, k 4, stride 2, no bias) -> the decoder transformer -> the
causal SEANet decoder. The numbers are moshi/models/loaders.py's
(``_seanet_kwargs``, ``_transformer_kwargs``, ``_quantizer_kwargs``) and
HF ``kyutai/mimi`` ``config.json``'s.

Public layouts are SoundStream's: wav ``[B, T]``, codes ``[n_q, B,
frames]`` int32 at 12.5 Hz, ``hop_length`` 1920 samples. ``encode(wav,
lengths=)`` takes a zero- or garbage-padded batch: before each strided conv
the frames past a clip's length are zeroed (the downsample's replicated
there), as the clip alone would be padded, so each clip's frames equal
those of the clip encoded alone, and its codes past ``ceil(length / hop)``
are zero. Streaming (a KV ring cache a layer, the resampling convs' state)
is not served: ``encode_stream`` / ``decode_stream`` raise.

Spans (``utils/profiling.py``) as SoundStream's, plus ``codec.transformer``
around each transformer call, inside ``codec.encoder`` / ``codec.decoder``.

State-dict keys follow the port's modules: ``encoder.model.N.conv.conv.weight``
and ``decoder...`` as moshi's SEANet; ``encoder_transformer.layers.N...`` and
``decoder_transformer...`` (moshi nests them one level deeper, under
``.transformer``); ``downsample.conv.conv.weight`` and
``upsample.convtr.convtr.weight`` (moshi: one level deeper);
``quantizer.rvq_first`` / ``quantizer.rvq_rest`` with ``input_proj``,
``output_proj`` and ``vq.layers.N._codebook.embed`` (moshi keeps
``embedding_sum`` and ``cluster_usage``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d, SConv1d, SConvTranspose1d
from academicodec_tpu_torch.nn.seanet import SEANetDecoder, SEANetEncoder
from academicodec_tpu_torch.nn.transformer import SlidingWindowTransformer
from academicodec_tpu_torch.quant.core_vq import ResidualVQ
from academicodec_tpu_torch.quant.vq import SplitResidualVectorQuantizer
from academicodec_tpu_torch.utils import profiling


# moshi's values, which every Mimi takes
LAYER_SCALE_INIT = 0.01
ROPE_MAX_PERIOD = 10000.0
SEMANTIC_CODEBOOKS = 1


class Mimi(nn.Module):
    def __init__(
        self,
        n_filters: int = 64,
        dimension: int = 512,
        ratios: Tuple[int, ...] = (8, 6, 5, 4),
        sample_rate: int = 24000,
        num_layers: int = 8,
        num_heads: int = 8,
        ffn_dim: int = 2048,
        context: int = 250,
        n_q: int = 32,
        codebook_dim: int = 256,
        bins: int = 2048,
        *,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        """Builds the model with random weights drawn from ``seed`` on the CPU
        (identical on every device; every LayerScale at the published
        ``LAYER_SCALE_INIT``), then moves it to ``device`` and ``dtype``. The
        codes' frame rate is half the encoder's, ``sample_rate / prod(ratios) / 2``."""
        super().__init__()
        device = resolve_device(device)
        self.ratios, self.sample_rate = tuple(ratios), sample_rate
        self.encoder_hop = math.prod(self.ratios)
        self.frame_rate = sample_rate / self.hop_length
        seanet = dict(
            n_filters=n_filters, dimension=dimension, ratios=self.ratios, norm="none", kernel_size=7,
            last_kernel_size=3, residual_kernel_size=3, causal=True, pad_mode="constant", true_skip=True,
            compress=2, lstm=0,
        )
        transformer = dict(dim=dimension, num_heads=num_heads, num_layers=num_layers, ffn_dim=ffn_dim,
                           context=context, max_period=ROPE_MAX_PERIOD)
        self.encoder = SEANetEncoder(**seanet)
        self.encoder_transformer = SlidingWindowTransformer(**transformer)
        self.downsample = SConv1d(dimension, dimension, 4, stride=2, bias=False, causal=True, norm="none",
                                  pad_mode="replicate")
        self.quantizer = SplitResidualVectorQuantizer(dimension, codebook_dim, n_q, SEMANTIC_CODEBOOKS, bins)
        self.upsample = SConvTranspose1d(dimension, dimension, 4, stride=2, causal=True, bias=False, norm="none",
                                         groups=dimension)
        self.decoder_transformer = SlidingWindowTransformer(**transformer)
        self.decoder = SEANetDecoder(**seanet)
        generator = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv1d, ConvTranspose1d, ResidualVQ)):
                m.reset_parameters(generator)
            elif isinstance(m, SlidingWindowTransformer):
                m.reset_parameters(generator, LAYER_SCALE_INIT)
        self.to(device=device, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.quantizer.rvq_first.vq.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.quantizer.rvq_first.vq.embed.dtype

    @property
    def hop_length(self) -> int:
        return 2 * self.encoder_hop

    @property
    def n_q(self) -> int:
        return self.quantizer.n_q

    def frames_for(self, samples: int) -> int:
        """Codes frames of a clip of ``samples``."""
        return -(-samples // self.hop_length)

    def _encoder_frames(self, x: torch.Tensor, lengths: Optional[List[int]]) -> torch.Tensor:
        """SEANet encoder ``[B, 1, T]`` -> ``[B, D, T / encoder_hop]``; with ``lengths``
        the frames past each clip's length are zeroed in front of each strided conv."""
        if lengths is None:
            return self.encoder(x)
        for layer in self.encoder.model:
            if isinstance(layer, SConv1d) and layer.stride > 1:
                x = x * _before(lengths, x.shape[-1], x.device)[:, None, :].to(x.dtype)
                lengths = [-(-n // layer.stride) for n in lengths]
            x = layer(x)
        return x

    @torch.no_grad()
    @profiling.span("codec.encode")
    def encode(self, x, n_q: Optional[int] = None, lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """wav ``[B, T]`` -> codes ``[n_q, B, ceil(T / hop_length)]`` int32 (all
        codebooks for None). ``lengths``: each clip's valid samples (module docstring)."""
        if lengths is not None:
            lengths = [int(n) for n in lengths]
        with profiling.span("codec.upload"):
            x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        with profiling.span("codec.encoder"):
            e = self._encoder_frames(x[:, None, :], lengths)
            with profiling.span("codec.transformer"):
                e = self.encoder_transformer(e.transpose(1, 2)).transpose(1, 2)
            if lengths is not None:  # the downsample's right padding replicates a clip's last frame
                frames = [-(-n // self.encoder_hop) for n in lengths]
                last = torch.tensor([f - 1 for f in frames], device=e.device)[:, None]
                t = torch.arange(e.shape[-1], device=e.device).minimum(last)
                e = e.gather(2, t[:, None, :].expand(-1, e.shape[1], -1))
            e = self.downsample(e)
        with profiling.span("codec.quantize"):
            codes = self.quantizer.encode(e, n_q)
            if lengths is not None:
                codes = codes * _before([self.frames_for(n) for n in lengths], codes.shape[-1], codes.device)
        return codes

    @torch.no_grad()
    @profiling.span("codec.decode")
    def decode(self, codes) -> torch.Tensor:
        """codes ``[n, B, frames]`` -> wav ``[B, frames * hop_length]``."""
        with profiling.span("codec.upload"):
            codes = torch.as_tensor(codes).to(device=self.device)
        with profiling.span("codec.dequantize"):
            q = self.quantizer.decode(codes)
        with profiling.span("codec.decoder"):
            q = self.upsample(q)
            with profiling.span("codec.transformer"):
                q = self.decoder_transformer(q.transpose(1, 2)).transpose(1, 2)
            return self.decoder(q)[:, 0, :]

    def encode_stream(self, *args, **kwargs):
        raise NotImplementedError("Mimi is served over whole clips here: streaming encode is not implemented")

    def decode_stream(self, *args, **kwargs):
        raise NotImplementedError("Mimi is served over whole clips here: streaming decode is not implemented")


def _before(lengths: List[int], T: int, device) -> torch.Tensor:
    """``[B, T]`` int32: 1 at the positions before each row's length, 0 after."""
    return (torch.arange(T, device=device)[None, :] < torch.tensor(lengths, device=device)[:, None]).int()
