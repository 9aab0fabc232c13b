"""Named SoundStream presets for the reference recipe operating points.

The port's copy of the SoundStream half of
``academicodec_tpu/models/presets.py``; the HiFi-Codec presets come with
the HiFi-Codec port.
"""

from __future__ import annotations

from typing import Dict

from academicodec_tpu_torch.models.soundstream import SoundStream

SOUNDSTREAM_PRESETS: Dict[str, dict] = {
    # egs/Encodec_16k_320d/start.sh:9-18
    "encodec_16k_320d": dict(
        n_filters=32, dimension=512, ratios=(8, 5, 4, 2), sample_rate=16000,
        target_bandwidths=(1, 1.5, 2, 4, 6, 12),
    ),
    # egs/Encodec_24k_240d/start.sh:9-17
    "encodec_24k_240d": dict(
        n_filters=32, dimension=512, ratios=(6, 5, 4, 2), sample_rate=24000,
        target_bandwidths=(1, 2, 4, 8, 12),
    ),
    # egs/Encodec_24k_32d/start.sh:9-18 (single-codebook use case)
    "encodec_24k_32d": dict(
        n_filters=32, dimension=512, ratios=(2, 2, 2, 4), sample_rate=24000,
        target_bandwidths=(7.5, 15),
    ),
    # egs/SoundStream_24k_240d (same generator as encodec_24k_240d)
    "soundstream_24k_240d": dict(
        n_filters=32, dimension=512, ratios=(6, 5, 4, 2), sample_rate=24000,
        target_bandwidths=(1, 2, 4, 8, 12),
    ),
}


def names():
    return sorted(SOUNDSTREAM_PRESETS)


def build(name: str, **kwargs) -> SoundStream:
    """Build a preset; ``kwargs`` override preset fields or pass ``device``,
    ``dtype`` and ``seed`` to :class:`SoundStream`."""
    if name not in SOUNDSTREAM_PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {names()}")
    return SoundStream(**{**SOUNDSTREAM_PRESETS[name], **kwargs})
