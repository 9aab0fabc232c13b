"""High-level entry point: build a preset and load weights in one call."""

from __future__ import annotations

from typing import Optional, Union

import torch

from academicodec_tpu_torch.models import presets
from academicodec_tpu_torch.models.dac import DAC
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.mimi import Mimi
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.utils import profiling


def reference_state_dict(ckpt: dict) -> dict:
    """A reference SoundStream ``state_dict`` from a loaded checkpoint: the flat
    ``best_*.pth`` dict, or the ``'soundstream'`` entry of a reference
    ``latest.pth`` or of a port training checkpoint (``utils/checkpoint.py``,
    ``<prefix>_<step>.pt``), with DDP ``module.`` prefixes removed."""
    sd = ckpt.get("soundstream", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


@profiling.span("codec.load")
def load_codec(
    preset: str,
    checkpoint: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
    *,
    seed: int = 0,
    **overrides,
) -> Union[SoundStream, VQVAE, Mimi, DAC]:
    """Build a preset on ``device`` and load its weights.

    ``checkpoint`` is a reference PyTorch file (a SoundStream ``.pth``, or a
    HiFi-Codec ``g_*`` dict ``{'generator', 'encoder', 'quantizer'}``), a
    ``state_dict`` of the port's Mimi (``models/mimi.py``) or DAC
    (``models/dac.py``, DAC's own keys), a port
    training checkpoint of ``cli/train_encodec.py`` (``latest_<step>.pt``) or
    ``cli/train_hificodec.py`` (``state_<step>.pt``, which holds the ``g_*``
    parts), or None for random weights drawn from ``seed``. The default device is the
    card; without one this raises rather than running on the CPU.

    The whole call is one ``codec.load`` span (``utils/profiling.py``).
    """
    model = presets.build(preset, device=device, dtype=dtype, seed=seed, **overrides)
    if checkpoint is not None:
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if isinstance(model, VQVAE):
            model.load_reference(ckpt)
        else:
            model.load_state_dict(reference_state_dict(ckpt))
    return model
