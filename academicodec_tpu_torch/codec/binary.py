"""ECDC container + LSB-first bit packing (host-side).

The port's copy of ``academicodec_tpu/codec/binary.py``: the same bytes.

Byte-identical to the Encodec compressed-audio format (reference
academicodec/binary.py): ``ECDC`` magic, version byte, uint32 JSON-metadata
length, metadata, then a raw bit stream. Values are packed LSB-first at an
arbitrary bit width (e.g. 10-bit codebook indices); flushing may append up
to ``8 // bits`` ghost values, which decoders must tolerate.

This layer is sequential byte-shuffling and deliberately stays on the host;
the device boundary is ``encode() -> int32 tokens``.
"""

from __future__ import annotations

import ctypes
import json
import struct
import typing as tp

import numpy as np

_HEADER_STRUCT = struct.Struct("!4sBI")
_MAGIC = b"ECDC"
_VERSION = 0


def write_ecdc_header(fo: tp.IO[bytes], metadata: tp.Any) -> None:
    blob = json.dumps(metadata).encode("utf-8")
    fo.write(_HEADER_STRUCT.pack(_MAGIC, _VERSION, len(blob)))
    fo.write(blob)
    fo.flush()


def _read_exactly(fo: tp.IO[bytes], size: int) -> bytes:
    parts = []
    remaining = size
    while remaining > 0:
        buf = fo.read(remaining)
        if not buf:
            raise EOFError(
                f"Impossible to read enough data from the stream, {remaining} bytes remaining."
            )
        parts.append(buf)
        remaining -= len(buf)
    return b"".join(parts)


def read_ecdc_header(fo: tp.IO[bytes]) -> tp.Any:
    magic, version, meta_size = _HEADER_STRUCT.unpack(
        _read_exactly(fo, _HEADER_STRUCT.size)
    )
    if magic != _MAGIC:
        raise ValueError("File is not in ECDC format.")
    if version != _VERSION:
        raise ValueError("Version not supported.")
    return json.loads(_read_exactly(fo, meta_size).decode("utf-8"))


class BitPacker:
    """Pack fixed-width ints LSB-first into a byte stream."""

    def __init__(self, bits: int, fo: tp.IO[bytes]):
        self.bits = bits
        self.fo = fo
        self._acc = 0
        self._acc_bits = 0

    def push(self, value: int) -> None:
        self._acc |= value << self._acc_bits
        self._acc_bits += self.bits
        while self._acc_bits >= 8:
            self.fo.write(bytes([self._acc & 0xFF]))
            self._acc >>= 8
            self._acc_bits -= 8

    def flush(self) -> None:
        if self._acc_bits:
            self.fo.write(bytes([self._acc & 0xFF]))
            self._acc = 0
            self._acc_bits = 0
        self.fo.flush()


class BitUnpacker:
    """Inverse of :class:`BitPacker`; returns ``None`` at end of stream."""

    def __init__(self, bits: int, fo: tp.IO[bytes]):
        self.bits = bits
        self.fo = fo
        self._mask = (1 << bits) - 1
        self._acc = 0
        self._acc_bits = 0

    def pull(self) -> tp.Optional[int]:
        while self._acc_bits < self.bits:
            buf = self.fo.read(1)
            if not buf:
                return None
            self._acc |= buf[0] << self._acc_bits
            self._acc_bits += 8
        out = self._acc & self._mask
        self._acc >>= self.bits
        self._acc_bits -= self.bits
        return out


# ---------------------------------------------------------------------------
# array paths: the native packer (native/bitpack.cpp via ctypes) when it
# builds, numpy otherwise; both write the bytes of BitPacker/BitUnpacker
# ---------------------------------------------------------------------------


def pack_array_numpy(values: np.ndarray, bits: int) -> bytes:
    """:func:`pack_array` in numpy: each value's ``bits`` bits, LSB first,
    in one little-endian bit stream."""
    values = np.asarray(values, dtype=np.int64).reshape(-1)
    planes = (values[:, None] >> np.arange(bits)) & 1
    return np.packbits(planes.astype(np.uint8).ravel(), bitorder="little").tobytes()


def unpack_array_numpy(blob: bytes, bits: int, count: int) -> np.ndarray:
    """:func:`unpack_array` in numpy."""
    if count * bits > 8 * len(blob):
        raise EOFError("truncated bit stream")
    planes = np.unpackbits(np.frombuffer(blob, dtype=np.uint8), bitorder="little")[: count * bits]
    return (planes.reshape(count, bits).astype(np.int32) << np.arange(bits, dtype=np.int32)).sum(1, dtype=np.int32)


def pack_array(values: np.ndarray, bits: int) -> bytes:
    """Pack an int array at ``bits`` bits/value — identical stream to
    pushing each value through :class:`BitPacker` and flushing."""
    values = np.ascontiguousarray(values, dtype=np.int32).reshape(-1)
    from academicodec_tpu_torch.native.build import get_bitpack_lib

    lib = get_bitpack_lib()
    if lib is None:
        return pack_array_numpy(values, bits)
    out = np.empty((values.size * bits + 7) // 8 + 1, dtype=np.uint8)
    n = lib.bitpack(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.size,
        bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:n].tobytes()


def unpack_array(blob: bytes, bits: int, count: int) -> np.ndarray:
    """Unpack exactly ``count`` values; raises EOFError on truncation."""
    from academicodec_tpu_torch.native.build import get_bitpack_lib

    lib = get_bitpack_lib()
    if lib is None:
        return unpack_array_numpy(blob, bits, count)
    data = np.frombuffer(blob, dtype=np.uint8)
    out = np.empty(count, dtype=np.int32)
    n = lib.bitunpack(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.size,
        bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        count,
    )
    if n < count:
        raise EOFError("truncated bit stream")
    return out
