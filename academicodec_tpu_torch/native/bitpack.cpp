// Native bit-packing for ECDC token streams (host code, not a device kernel).
//
// The device boundary is `encode() -> int32 tokens`; packing those tokens
// LSB-first at an arbitrary bit width is host-side and sequential. The
// reference does this in a pure-Python byte loop (academicodec/binary.py);
// this C implementation is the fast path, bound with ctypes, with the numpy
// packer of codec/binary.py kept for a host without a C++ compiler. The port's
// copy of academicodec_tpu/native/bitpack.cpp: the same bytes.
//
// Build: native/build.py (the host C++ compiler, -O3 -shared -fPIC, at first use).

#include <cstdint>
#include <cstddef>

extern "C" {

// Pack `n` values of `bits` bits each (LSB-first across the stream) into
// `out`. Returns the number of bytes written. `out` must have space for
// (n * bits + 7) / 8 bytes. Matches BitPacker.push/flush byte-for-byte.
int64_t bitpack(const int32_t* values, int64_t n, int32_t bits, uint8_t* out) {
    uint64_t acc = 0;
    int32_t acc_bits = 0;
    int64_t written = 0;
    for (int64_t i = 0; i < n; ++i) {
        acc |= (uint64_t)(uint32_t)values[i] << acc_bits;
        acc_bits += bits;
        while (acc_bits >= 8) {
            out[written++] = (uint8_t)(acc & 0xff);
            acc >>= 8;
            acc_bits -= 8;
        }
    }
    if (acc_bits > 0) {
        out[written++] = (uint8_t)(acc & 0xff);
    }
    return written;
}

// Unpack `count` values of `bits` bits each from `data` (`n_bytes` long)
// into `out`. Returns the number of values produced (may be less than
// `count` if the stream is short). Matches BitUnpacker.pull.
int64_t bitunpack(const uint8_t* data, int64_t n_bytes, int32_t bits,
                  int32_t* out, int64_t count) {
    uint64_t acc = 0;
    int32_t acc_bits = 0;
    int64_t pos = 0;
    int64_t produced = 0;
    const uint32_t mask = (bits >= 32) ? 0xffffffffu : ((1u << bits) - 1u);
    while (produced < count) {
        while (acc_bits < bits) {
            if (pos >= n_bytes) return produced;
            acc |= (uint64_t)data[pos++] << acc_bits;
            acc_bits += 8;
        }
        out[produced++] = (int32_t)(acc & mask);
        acc >>= bits;
        acc_bits -= bits;
    }
    return produced;
}

}  // extern "C"
