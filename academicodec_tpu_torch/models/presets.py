"""Named model presets for the reference recipe operating points.

The port's copy of ``academicodec_tpu/models/presets.py``:
``build("encodec_24k_240d")`` gives a SoundStream, ``build("hificodec_24k_320d")``
a HiFi-Codec VQVAE, each configured as the reference recipe trains and
serves it (egs/*/start.sh flags and config JSONs). ``build("mimi_24k_1920d")``
gives Kyutai's Mimi (``models/mimi.py``) and ``build("dac_44k_512d")`` the
Descript Audio Codec (``models/dac.py``), which only the port has.
"""

from __future__ import annotations

from typing import Dict, Union

from academicodec_tpu_torch.models.dac import DAC
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.mimi import Mimi
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig

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

HIFICODEC_PRESETS: Dict[str, dict] = {
    # egs/HiFi-Codec-24k-320d/config_24k_320d.json
    "hificodec_24k_320d": dict(
        upsample_rates=(8, 5, 4, 2), upsample_kernel_sizes=(16, 11, 8, 4),
        sampling_rate=24000, segment_size=16000, hop_size=240,
        n_fft=1024, win_size=1024,
    ),
    # egs/HiFi-Codec-16k-320d/config_16k_320d.json
    "hificodec_16k_320d": dict(
        upsample_rates=(8, 5, 4, 2), upsample_kernel_sizes=(16, 11, 8, 4),
        sampling_rate=16000, segment_size=16000, hop_size=200,
        n_fft=1024, win_size=800,
    ),
    # egs/HiFi-Codec-24k-240d/config_24k_240d.json
    "hificodec_24k_240d": dict(
        upsample_rates=(8, 5, 3, 2), upsample_kernel_sizes=(16, 11, 7, 4),
        sampling_rate=24000, segment_size=12000, hop_size=240,
        n_fft=1024, win_size=1024,
    ),
}

MIMI_PRESETS: Dict[str, dict] = {
    # https://huggingface.co/kyutai/mimi/blob/main/config.json; moshi/models/loaders.py
    "mimi_24k_1920d": dict(
        n_filters=64, dimension=512, ratios=(8, 6, 5, 4), sample_rate=24000,
        num_layers=8, num_heads=8, ffn_dim=2048, context=250, n_q=32, codebook_dim=256, bins=2048,
    ),
}

DAC_PRESETS: Dict[str, dict] = {
    # https://huggingface.co/descript/dac_44khz/blob/main/config.json; descript-audio-codec conf/final/44khz.yml
    "dac_44k_512d": dict(
        encoder_dim=64, encoder_rates=(2, 4, 8, 8), latent_dim=1024, decoder_dim=1536, decoder_rates=(8, 8, 4, 2),
        n_codebooks=9, codebook_size=1024, codebook_dim=8, sample_rate=44100,
    ),
}

# keyword arguments of the VQVAE module itself; the rest configure HiFiCodecConfig
_VQVAE_KW = ("norm", "int8_min_channels", "device", "dtype", "seed")


def names():
    return sorted(list(SOUNDSTREAM_PRESETS) + list(HIFICODEC_PRESETS) + list(MIMI_PRESETS) + list(DAC_PRESETS))


def build(name: str, **kwargs) -> Union[SoundStream, VQVAE, Mimi, DAC]:
    """Build a preset; ``kwargs`` override preset fields or pass ``device``,
    ``dtype`` and ``seed`` (and ``norm``, and HiFi-Codec's ``int8_min_channels``)
    to the model."""
    if name in SOUNDSTREAM_PRESETS:
        return SoundStream(**{**SOUNDSTREAM_PRESETS[name], **kwargs})
    if name in HIFICODEC_PRESETS:
        kw = {**HIFICODEC_PRESETS[name], **kwargs}
        module_kw = {k: kw.pop(k) for k in _VQVAE_KW if k in kw}
        return VQVAE(config=HiFiCodecConfig(**kw), **module_kw)
    if name in MIMI_PRESETS:
        return Mimi(**{**MIMI_PRESETS[name], **kwargs})
    if name in DAC_PRESETS:
        return DAC(**{**DAC_PRESETS[name], **kwargs})
    raise KeyError(f"unknown preset {name!r}; available: {names()}")
