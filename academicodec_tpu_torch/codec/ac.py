"""Range (arithmetic) coder over per-step quantized CDFs, on the host.

The port's copy of ``academicodec_tpu/codec/ac.py`` (the reference's
academicodec/quantization/ac.py on numpy arrays): the range ``[low, high]``
is split in proportion to a quantized CDF, the chosen symbol's sub-range
becomes the new range, and the common high bits of ``low`` and ``high`` go
out through a 1-bit :class:`BitPacker`. It is integer-exact: given the same
pdfs it writes the JAX package's bytes. The pdfs themselves must be
bit-identical on both sides; :func:`build_stable_quantized_cdf` floors them
to ``roundoff`` (1e-8) first.

Behavioral parity target: academicodec_tpu/codec/ac.py:26-163.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np

from academicodec_tpu_torch.codec.binary import BitPacker, BitUnpacker


def build_stable_quantized_cdf(
    pdf: np.ndarray,
    total_range_bits: int,
    roundoff: float = 1e-8,
    min_range: int = 2,
    check: bool = True,
) -> np.ndarray:
    """PDF -> integer CDF over ``[0, 2**total_range_bits]`` with a
    ``min_range`` floor per symbol (so rare symbols stay codable) and a
    roundoff that removes cross-platform float jitter."""
    pdf = np.asarray(pdf, dtype=np.float64)
    if roundoff:
        pdf = np.floor(pdf / roundoff) * roundoff
    total_range = 2**total_range_bits
    cardinality = len(pdf)
    alpha = min_range * cardinality / total_range
    assert alpha <= 1, "you must reduce min_range"
    ranges = np.floor(((1 - alpha) * total_range) * pdf).astype(np.int64)
    ranges += min_range
    quantized_cdf = np.cumsum(ranges)
    if min_range < 2:
        raise ValueError("min_range must be at least 2.")
    if check:
        assert quantized_cdf[-1] <= 2**total_range_bits, quantized_cdf[-1]
        if (np.diff(quantized_cdf) < min_range).any() or quantized_cdf[0] < min_range:
            raise ValueError("You must increase your total_range_bits.")
    return quantized_cdf


class ArithmeticCoder:
    def __init__(self, fo: tp.IO[bytes], total_range_bits: int = 24):
        assert total_range_bits <= 30
        self.total_range_bits = total_range_bits
        self.packer = BitPacker(bits=1, fo=fo)
        self.low: int = 0
        self.high: int = 0
        self.max_bit: int = -1

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        assert self.high >= self.low, (self.low, self.high)
        assert self.high < 2 ** (self.max_bit + 1)
        while self.max_bit >= 0:
            b_low = self.low >> self.max_bit
            b_high = self.high >> self.max_bit
            if b_low != b_high:
                break
            self.low -= b_low << self.max_bit
            self.high -= b_low << self.max_bit
            assert self.high >= self.low >= 0
            self.max_bit -= 1
            self.packer.push(b_low)

    def push(self, symbol: int, quantized_cdf: np.ndarray) -> None:
        """Encode one symbol against its (en/decoder-identical) CDF."""
        while self.delta < 2**self.total_range_bits:
            self.low *= 2
            self.high = self.high * 2 + 1
            self.max_bit += 1

        range_low = 0 if symbol == 0 else int(quantized_cdf[symbol - 1])
        range_high = int(quantized_cdf[symbol]) - 1
        scale = self.delta / (2**self.total_range_bits)
        effective_low = int(math.ceil(range_low * scale))
        effective_high = int(math.floor(range_high * scale))
        assert self.low <= self.high
        self.high = self.low + effective_high
        self.low = self.low + effective_low
        assert self.low <= self.high, (effective_low, effective_high, range_low, range_high)
        self._flush_common_prefix()
        assert self.low <= self.high
        assert -1 <= self.max_bit <= 61

    def flush(self) -> None:
        while self.max_bit >= 0:
            self.packer.push((self.low >> self.max_bit) & 1)
            self.max_bit -= 1
        self.packer.flush()


class ArithmeticDecoder:
    def __init__(self, fo: tp.IO[bytes], total_range_bits: int = 24):
        self.total_range_bits = total_range_bits
        self.unpacker = BitUnpacker(bits=1, fo=fo)
        self.low: int = 0
        self.high: int = 0
        self.current: int = 0
        self.max_bit: int = -1

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        while self.max_bit >= 0:
            b_low = self.low >> self.max_bit
            b_high = self.high >> self.max_bit
            if b_low != b_high:
                break
            self.low -= b_low << self.max_bit
            self.high -= b_low << self.max_bit
            self.current -= b_low << self.max_bit
            assert self.high >= self.low >= 0
            self.max_bit -= 1

    def pull(self, quantized_cdf: np.ndarray) -> tp.Optional[int]:
        """Decode one symbol; ``None`` when the stream is exhausted."""
        while self.delta < 2**self.total_range_bits:
            bit = self.unpacker.pull()
            if bit is None:
                return None
            self.low *= 2
            self.high = self.high * 2 + 1
            self.current = self.current * 2 + bit
            self.max_bit += 1

        scale = self.delta / (2**self.total_range_bits)

        def locate(low_idx: int, high_idx: int):
            if high_idx < low_idx:
                raise RuntimeError("Binary search failed")
            mid = (low_idx + high_idx) // 2
            range_low = int(quantized_cdf[mid - 1]) if mid > 0 else 0
            range_high = int(quantized_cdf[mid]) - 1
            low = int(math.ceil(range_low * scale)) + self.low
            high = int(math.floor(range_high * scale)) + self.low
            if self.current < low:
                return locate(low_idx, mid - 1)
            if self.current > high:
                return locate(mid + 1, high_idx)
            return mid, low, high

        sym, self.low, self.high = locate(0, len(quantized_cdf) - 1)
        self._flush_common_prefix()
        return sym
