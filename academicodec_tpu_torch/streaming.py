"""Streaming codec sessions: chunked encode and decode for causal models.

Each session keeps the state of one stream, the carried inputs of every
conv, the overlap-add tails of every conv-transpose and the SLSTM's (h, c),
as explicit tensors that it passes to the model's ``encode_stream`` /
``decode_stream`` and gets back with each chunk. The model holds no state of
a stream, so any number of sessions share one model without interfering.
Conv state is kept in the model's dtype and the LSTM carry in f32. On the
card every chunk runs the kernels of the full path: the RVQ search (encoder)
and the 2-layer LSTM with its carry (both directions).

Encodec chunks must be a multiple of the hop length, so that every strided
conv consumes whole windows; HiFi-Codec token chunks may have any length.
Chunk after chunk equals one full-length causal call (exactly for
``pad_mode='zero'``, up to float summation order).

Behavioral parity target: academicodec_tpu/streaming.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.soundstream import SoundStream


class _StreamingSession:
    """One stream: ``process`` feeds a chunk through ``step(chunk, state)``
    and keeps the state it returns; ``reset`` starts the stream anew."""

    def __init__(self, step):
        self._step = step
        self.state = None

    def reset(self) -> None:
        self.state = None

    def process(self, chunk) -> torch.Tensor:
        out, self.state = self._step(chunk, self.state)
        return out


class StreamingEncoder(_StreamingSession):
    """Feed wav chunks ``[B, chunk]``, get codes ``[n_q - st, B, chunk / hop]``."""

    def __init__(self, model: SoundStream, target_bw: Optional[float] = None, st: int = 0):
        if not model.causal:
            raise ValueError("streaming needs a causal model")
        self.model = model
        super().__init__(lambda chunk, state: model.encode_stream(chunk, state, target_bw=target_bw, st=st))


class StreamingDecoder(_StreamingSession):
    """Feed code chunks ``[n, B, frames]``, get wav ``[B, frames * hop]``."""

    def __init__(self, model: SoundStream):
        if not model.causal:
            raise ValueError("streaming needs a causal model")
        self.model = model
        super().__init__(model.decode_stream)


class StreamingVQVAEDecoder(_StreamingSession):
    """Chunked HiFi-Codec decode for causal configs: feed token chunks
    ``[B, frames, n_res * G]``, get wav ``[B, frames * hop]``, the incremental
    synthesis that token generators (VALL-E/SoundStorm style) consume."""

    def __init__(self, model: VQVAE):
        if not model.config.causal:
            raise ValueError("streaming decode needs a causal config")
        self.model = model
        super().__init__(model.decode_stream)
