"""Native (C++ thread pool) training batch loader.

The port of ``academicodec_tpu/data/native_loader.py``.
``native_batch_iterator`` has the contract of ``dataset.batch_iterator``
for plain wav-crop datasets: per-epoch reshuffle, DistributedSampler-style
rank sharding, drop_last, mixture augmentation, corrupt-file noise fallback.
The read path seeks straight to the crop window instead of decoding whole
files, and batches are assembled off the GIL into a bounded prefetch queue
(``native/wavloader.cpp``, built by ``native/build.py``). Both pipelines
draw from the same ``(seed, epoch, item)``-keyed mt19937_64 streams
(``data/mt64.py``), so for one seed, file list and shard the batches are
bit-identical, except the corrupt-file noise fallback, whose values are
each backend's own. A library that cannot be built raises: nothing
switches to the Python pipeline on its own.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Iterator, List, Optional

import numpy as np

from academicodec_tpu_torch.data.wavio import read_wav
from academicodec_tpu_torch.native.build import get_wavloader_lib

PREFETCH = 4  # batches the native side assembles ahead of the consumer


def native_loader_available() -> bool:
    """Whether the loader's library builds and loads here."""
    try:
        get_wavloader_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeWavLoader:
    """Owns the native loader handle; yields ``[batch, segment]`` float32."""

    def __init__(
        self,
        files: List[str],
        segment_length: int,
        batch_size: int,
        *,
        sample_rate: int = 0,
        mixture_prob: float = 0.0,
        seed: int = 0,
        num_workers: int = 8,
        process_index: int = 0,
        process_count: int = 1,
        start_epoch: int = 0,
    ):
        self._handle = None
        lib = get_wavloader_lib()
        if not files:
            raise ValueError("empty file list")
        if sample_rate:
            # eager guard for the common all-wrong-rate corpus: the native path
            # never resamples (mismatched files degrade to the noise fallback)
            try:
                _, sr0 = read_wav(files[0])
            except Exception:
                sr0 = sample_rate  # corrupt first file: the runtime fallback
            if sr0 != sample_rate:
                raise ValueError(
                    f"{files[0]}: sample rate {sr0} != expected {sample_rate}; "
                    "the native loader does not resample — use the Python "
                    "pipeline (batch_iterator) for resampling corpora"
                )
        self._lib = lib
        self.batch_size = batch_size
        self.segment_length = segment_length
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        self._handle = lib.wavloader_create(
            arr, len(files), segment_length, int(sample_rate), float(mixture_prob),
            batch_size, seed & (2**64 - 1), num_workers, process_index,
            max(process_count, 1), PREFETCH, start_epoch,
        )
        if not self._handle:
            raise ValueError("wavloader_create failed (fewer files than a batch after sharding, or bad arguments)")
        self.batches_per_epoch = int(lib.wavloader_batches_per_epoch(self._handle))
        self._warned_fallbacks = False

    @property
    def fallbacks(self) -> int:
        """Noise substitutions served so far (corrupt header, mismatched
        sample rate, failed read). A healthy corpus keeps this at 0."""
        if not self._handle:
            return 0
        return int(self._lib.wavloader_fallbacks(self._handle))

    def next(self) -> np.ndarray:
        """Blocking: a fresh ``[batch, segment]`` float32 array (the native
        side copies straight into it)."""
        buf = np.empty((self.batch_size, self.segment_length), np.float32)
        self._lib.wavloader_next(self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not self._warned_fallbacks:
            fb = self.fallbacks
            if fb:
                self._warned_fallbacks = True
                warnings.warn(
                    f"native wav loader substituted noise for {fb} sample(s) so far (corrupt file, "
                    "mismatched sample rate, or failed read) — check the corpus; poll .fallbacks for totals",
                    stacklevel=2,
                )
        return buf

    def close(self):
        if self._handle:
            self._lib.wavloader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def native_batch_iterator(
    files: List[str],
    segment_length: int,
    batch_size: int,
    *,
    sample_rate: int = 0,
    mixture_prob: float = 0.0,
    seed: int = 0,
    num_workers: int = 8,
    epochs: Optional[int] = None,
    process_index: int = 0,
    process_count: int = 1,
    start_epoch: int = 0,
) -> Iterator[np.ndarray]:
    """``start_epoch`` offsets every stream's epoch key, so a resumed run
    reproduces the original run's order (both loaders take it and stay
    bit-identical). ``batch_size`` is per process."""
    loader = NativeWavLoader(
        files, segment_length, batch_size, sample_rate=sample_rate,
        mixture_prob=mixture_prob, seed=seed, num_workers=num_workers,
        process_index=process_index, process_count=process_count,
        start_epoch=start_epoch,
    )
    try:
        total = None if epochs is None else epochs * loader.batches_per_epoch
        n = 0
        while total is None or n < total:
            yield loader.next()
            n += 1
    finally:
        loader.close()
