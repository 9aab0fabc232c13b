"""``std::mt19937_64``-compatible RNG and the loaders' seeding scheme.

The port's copy of academicodec_tpu/data/mt64.py: every random decision of
the data pipeline (the epoch shuffle, crop offsets, mixture draws) comes
from streams keyed on ``(seed, epoch, item)``, so that the port's
``batch_iterator`` yields the JAX package's batches bit for bit
(tests/test_torch_train.py) and batches do not depend on thread schedule.
"""

from __future__ import annotations

from typing import List

import numpy as np

_M64 = (1 << 64) - 1

# wavloader.cpp seed-mixing constants (golden-ratio / FNV / Pelle Evensen)
_SHUFFLE_MIX = 0x9E3779B97F4A7C15
_ITEM_XOR = 0xD1B54A32D192ED03
_ITEM_EPOCH = 0x100000001B3
_ITEM_MIX = 0x9E3779B97F4A7C15


class MT19937_64:
    """Bit-exact ``std::mt19937_64`` (value-seeded constructor only)."""

    _N = 312
    _M = 156
    _MATRIX_A = 0xB5026F5AA96619E9
    _UPPER = 0xFFFFFFFF80000000
    _LOWER = 0x7FFFFFFF

    def __init__(self, seed: int):
        mt = [0] * self._N
        mt[0] = seed & _M64
        for i in range(1, self._N):
            mt[i] = (
                6364136223846793005 * (mt[i - 1] ^ (mt[i - 1] >> 62)) + i
            ) & _M64
        self._mt = mt
        self._mti = self._N

    def next(self) -> int:
        """One 64-bit draw (``operator()`` of std::mt19937_64)."""
        if self._mti >= self._N:
            mt = self._mt
            N, M = self._N, self._M
            for i in range(N):
                x = (mt[i] & self._UPPER) | (mt[(i + 1) % N] & self._LOWER)
                xa = x >> 1
                if x & 1:
                    xa ^= self._MATRIX_A
                mt[i] = mt[(i + M) % N] ^ xa
            self._mti = 0
        x = self._mt[self._mti]
        self._mti += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x

    def uniform53(self) -> float:
        """53-bit uniform in [0, 1) — wavloader.cpp:206 mixture draw."""
        return (self.next() >> 11) * (1.0 / 9007199254740992.0)


def item_rng(seed: int, epoch: int, item: int) -> MT19937_64:
    """Per-(epoch, item) stream — wavloader.cpp ``Loader::item_rng``."""
    s = (
        ((seed & _M64) ^ _ITEM_XOR)
        + (epoch & _M64) * _ITEM_EPOCH
        + (item & _M64) * _ITEM_MIX
    ) & _M64
    return MT19937_64(s)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The native loader's per-epoch Fisher–Yates shuffle of [0, n)
    (wavloader.cpp ``Loader::reshuffle``), as an int64 index array."""
    idx: List[int] = list(range(n))
    rng = MT19937_64(((seed & _M64) * _SHUFFLE_MIX + (epoch & _M64)) & _M64)
    for i in range(n - 1, 0, -1):
        j = rng.next() % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx, dtype=np.int64)
