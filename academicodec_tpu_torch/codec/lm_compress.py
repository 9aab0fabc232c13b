"""LM entropy coding of token streams: LM probabilities and the range coder.

The LM (``models/lm.RVQTokenLM``) runs on its device one frame at a time and
gives the pdf of each stream's next token; the host's range coder
(``codec/ac.py``) codes the token against it. The ECDC header sets ``lm``,
so that ``codec/compress.decompress_tokens`` takes this path back.

The coder and the decoder must see bit-identical pdfs, or the range coder
desynchronizes. Both directions therefore run one step function of fixed
shapes: batch 1, one frame, the rolling states ``[1, past_context, dim]``
and the offset a tensor, never a teacher-forced pass over the whole stream,
whose other shapes would take other kernels and round differently. The
step also keeps TF32 off inside it, whatever the process-wide flags say, so
that a blob coded in one process decodes in another on the same kind of
device. Decoding on another device kind (the card's blob on the CPU, or in
the JAX package) is not guaranteed, as in JAX across platforms.

Behavioral parity target: academicodec_tpu/codec/lm_compress.py:32-105.
"""

from __future__ import annotations

import contextlib
import io
from typing import Optional, Tuple

import numpy as np
import torch

from academicodec_tpu_torch.codec.ac import ArithmeticCoder, ArithmeticDecoder, build_stable_quantized_cdf
from academicodec_tpu_torch.codec.binary import read_ecdc_header, write_ecdc_header


@contextlib.contextmanager
def _exact_f32_matmuls():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def make_step(lm):
    """The one LM step of both directions: ``(prev [1, 1, n_q] tokens on the
    LM's device, states, offset) -> (pdfs [n_q, bins] f64 numpy, next states,
    next offset)``; ``states`` None starts a stream."""

    @torch.no_grad()
    def step(prev: torch.Tensor, states, offset):
        if states is None:
            states = lm.init_states(1)
            offset = torch.zeros((), dtype=torch.long, device=lm.device)
        with _exact_f32_matmuls():
            probs, states, offset = lm.probabilities(prev, states, offset, fixed_state=True)
        return probs[0, 0].double().cpu().numpy(), states, offset

    return step


def _bos(lm, n_q: int) -> torch.Tensor:
    return torch.full((1, 1, n_q), lm.bins, dtype=torch.long, device=lm.device)


def compress_tokens_with_lm(lm, codes: np.ndarray, metadata: Optional[dict] = None) -> bytes:
    """codes ``[n_q, T]`` -> LM-entropy-coded ECDC bytes."""
    n_q, T = codes.shape
    step = make_step(lm)
    fo = io.BytesIO()
    meta = dict(metadata or {})
    meta.update(n_q=int(n_q), n_frames=int(T), lm=True)
    write_ecdc_header(fo, meta)
    coder = ArithmeticCoder(fo)
    prev, states, offset = _bos(lm, n_q), None, None
    for t in range(T):
        pdf, states, offset = step(prev, states, offset)  # [n_q, bins]
        for q in range(n_q):
            p = pdf[q]
            coder.push(int(codes[q, t]), build_stable_quantized_cdf(p / p.sum(), coder.total_range_bits))
        prev = torch.from_numpy(np.asarray(codes[:, t], np.int64).reshape(1, 1, n_q)).to(lm.device)
    coder.flush()
    return fo.getvalue()


def decompress_tokens_with_lm(lm, blob: bytes) -> Tuple[np.ndarray, dict]:
    """LM-coded ECDC bytes -> (codes ``[n_q, T]`` int32, metadata), one LM step a frame."""
    fo = io.BytesIO(blob)
    meta = read_ecdc_header(fo)
    if not meta.get("lm"):
        raise ValueError("the stream is not LM-coded")
    n_q, T = meta["n_q"], meta["n_frames"]
    step = make_step(lm)
    decoder = ArithmeticDecoder(fo)
    out = np.zeros((n_q, T), np.int32)
    prev, states, offset = _bos(lm, n_q), None, None
    for t in range(T):
        pdf, states, offset = step(prev, states, offset)
        for q in range(n_q):
            p = pdf[q]
            sym = decoder.pull(build_stable_quantized_cdf(p / p.sum(), decoder.total_range_bits))
            if sym is None:
                raise EOFError("truncated LM-coded stream")
            out[q, t] = sym
        prev = torch.from_numpy(out[:, t].astype(np.int64).reshape(1, 1, n_q)).to(lm.device)
    return out, meta
