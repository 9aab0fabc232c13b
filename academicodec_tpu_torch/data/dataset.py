"""Audio file lists, random crops, mixtures and batching for the trainers.

The port's copy of academicodec_tpu/data/dataset.py:40-268 (numpy only):
random fixed-length crops or zero pads (reference dataset.py:23-32), the
p=0.3 two-clip mixture of the SoundStream recipe (soundstream/dataset.py:27-48),
a low-level noise fallback for unreadable files (meldataset.py:143-149),
DistributedSampler-style sharding, and threaded prefetch into ``[B, T]``
f32 batches.

Every random decision is keyed on ``(seed, epoch, item)`` through the
``std::mt19937_64`` streams of ``data/mt64.py``, so for the same arguments
the batches equal the JAX package's bit for bit, whatever the thread
schedule. ``MelNpyCropDataset`` is HiFi-Codec fine-tuning's mel-aligned
crop, paired with its precomputed mel. ``data/native_loader.py`` draws the
same batches with a C++ thread pool.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os
import struct
from typing import Iterator, List, Optional

import numpy as np

from academicodec_tpu_torch.data.mt64 import MT19937_64, epoch_order, item_rng
from academicodec_tpu_torch.data.wavio import read_wav


def list_audio_files(source: str) -> List[str]:
    """``source`` is a directory (globbed for ``*.wav``, recursively) or a
    filelist with one path per line."""
    if os.path.isdir(source):
        files = sorted(
            glob.glob(os.path.join(source, "*.wav"))
            + glob.glob(os.path.join(source, "**", "*.wav"), recursive=True)
        )
        return sorted(set(files))
    with open(source) as fh:
        return [line.strip() for line in fh if line.strip()]


class WavCropDataset:
    """Random fixed-length crops from a list of wav files."""

    def __init__(self, source: str, segment_length: int, sample_rate: Optional[int] = None,
                 mixture_prob: float = 0.0, seed: int = 0):
        self.files = list_audio_files(source)
        if not self.files:
            raise ValueError(f"no audio files found in {source}")
        self.segment_length = segment_length
        self.sample_rate = sample_rate
        self.mixture_prob = mixture_prob
        self.seed = seed

    def __len__(self) -> int:
        return len(self.files)

    def _load_crop(self, path: str, rng: MT19937_64) -> np.ndarray:
        seg = self.segment_length
        try:
            wav, _sr = read_wav(path, sr=self.sample_rate)
        except (OSError, ValueError, EOFError, struct.error):  # unreadable file: low-level noise, as the reference
            return (np.random.default_rng(0).standard_normal(seg) * 0.05).astype(np.float32)
        if wav.shape[-1] > seg:
            st = rng.next() % (wav.shape[-1] - seg + 1)  # every offset reachable
            return wav[st : st + seg]
        out = np.zeros(seg, np.float32)
        out[: wav.shape[-1]] = wav
        return out

    def sample(self, index: int, *, epoch: int = 0, item: Optional[int] = None) -> np.ndarray:
        """The crop of file ``index``; ``(epoch, item)`` key its stream (``item``,
        the position in the epoch's sharded order, defaults to ``index``)."""
        if item is None:
            item = index
        rng = item_rng(self.seed, epoch, item)
        x = self._load_crop(self.files[index % len(self.files)], rng)
        # the threshold at f32, as the JAX package compares it
        if self.mixture_prob > 0 and rng.uniform53() < float(np.float32(self.mixture_prob)):
            other = rng.next() % len(self.files)
            x = x + self._load_crop(self.files[other], rng)
        return x


class MelNpyCropDataset(WavCropDataset):
    """Fine-tuning crops (reference meldataset.py:183-206): each file's
    precomputed mel ``base_mels_path/<stem>.npy`` (``[num_mels, frames]``, or
    with a leading batch dim of 1) and a crop aligned to its frames;
    ``sample`` returns ``(wav [segment], mel [num_mels, ceil(segment / hop)])``.
    A file or mel too short for a crop is zero-padded to those shapes. The
    mel is not the loss target (the trainer recomputes mels from the audio);
    it rides along for consumers that plot or condition on it."""

    def __init__(self, source: str, segment_length: int, hop_size: int, base_mels_path: str,
                 sample_rate: Optional[int] = None, seed: int = 0):
        super().__init__(source, segment_length, sample_rate=sample_rate, seed=seed)
        self.hop_size = hop_size
        self.base_mels_path = base_mels_path
        self.frames_per_seg = -(-segment_length // hop_size)

    def sample(self, index: int, *, epoch: int = 0, item: Optional[int] = None):
        if item is None:
            item = index
        rng = item_rng(self.seed, epoch, item)
        path = self.files[index % len(self.files)]
        stem = os.path.splitext(os.path.basename(path))[0]
        mel = np.load(os.path.join(self.base_mels_path, stem + ".npy"))
        if mel.ndim == 3:
            mel = mel[0]
        seg, hop, fps = self.segment_length, self.hop_size, self.frames_per_seg
        try:
            wav, _sr = read_wav(path, sr=self.sample_rate)
        except (OSError, ValueError, EOFError, struct.error):
            wav = (np.random.default_rng(0).standard_normal(seg) * 0.05).astype(np.float32)
        if wav.shape[-1] >= seg and mel.shape[-1] >= fps:
            start = rng.next() % (mel.shape[-1] - fps + 1)  # every frame offset reachable
            mel = mel[:, start:start + fps]
            wav = wav[start * hop:start * hop + seg]
            out = np.zeros(seg, np.float32)
            out[: wav.shape[-1]] = wav  # a ragged last hop
            return out, mel.astype(np.float32)
        mel_out = np.zeros((mel.shape[0], fps), np.float32)
        mel_out[:, : min(fps, mel.shape[-1])] = mel[:, :fps]
        wav_out = np.zeros(seg, np.float32)
        wav_out[: min(seg, wav.shape[-1])] = wav[:seg]
        return wav_out, mel_out


def shard_indices(idx: np.ndarray, process_index: int, process_count: int) -> np.ndarray:
    """DistributedSampler sharding: pad by wrapping so that every process draws
    the same count, then stride by rank."""
    if process_count <= 1:
        return idx
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in [0, {process_count})")
    pad = (-len(idx)) % process_count
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[process_index::process_count]


def batch_iterator(
    dataset: WavCropDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    drop_last: bool = True,
    num_workers: int = 8,
    seed: int = 0,
    epochs: Optional[int] = None,
    process_index: int = 0,
    process_count: int = 1,
    start_epoch: int = 0,
) -> Iterator[np.ndarray]:
    """``[batch_size, segment_length]`` f32 batches (a tuple of stacked columns
    for a dataset of pairs, :class:`MelNpyCropDataset`) with threaded prefetch;
    ``epochs=None`` streams forever, reshuffling each pass. ``start_epoch``
    offsets every stream's epoch key, so a resumed run continues the original
    order. ``batch_size`` is per process."""
    n = len(dataset)
    epoch = start_epoch
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        while epochs is None or epoch < start_epoch + epochs:
            idx = epoch_order(n, seed, epoch) if shuffle else np.arange(n)
            idx = shard_indices(idx, process_index, process_count)
            limit = (len(idx) // batch_size) * batch_size if drop_last else len(idx)

            def draw(args, _e=epoch):
                item, file_idx = args
                return dataset.sample(file_idx, epoch=_e, item=item)

            for start in range(0, limit, batch_size):
                chunk = idx[start : start + batch_size]
                batch = list(pool.map(draw, list(enumerate(chunk.tolist(), start=start))))
                if len(batch) < batch_size:
                    continue
                if isinstance(batch[0], tuple):
                    yield tuple(np.stack(col).astype(np.float32) for col in zip(*batch))
                else:
                    yield np.stack(batch).astype(np.float32)
            epoch += 1
