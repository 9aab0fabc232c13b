"""High-level entry point: build a preset and load weights in one call."""

from __future__ import annotations

from typing import Optional, Union

import torch

from academicodec_tpu_torch.models import presets
from academicodec_tpu_torch.models.soundstream import SoundStream


def reference_state_dict(ckpt: dict) -> dict:
    """A reference SoundStream ``state_dict`` from a loaded ``.pth``: the flat
    ``best_*.pth`` dict or the ``'soundstream'`` entry of ``latest.pth``,
    with DDP ``module.`` prefixes removed."""
    sd = ckpt.get("soundstream", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_codec(
    preset: str,
    checkpoint: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
    *,
    seed: int = 0,
    **overrides,
) -> SoundStream:
    """Build a SoundStream preset on ``device`` and load its weights.

    ``checkpoint`` is a reference PyTorch ``.pth`` file, or None for random
    weights drawn from ``seed``. The default device is the card; without one
    this raises rather than running on the CPU.
    """
    model = presets.build(preset, device=device, dtype=dtype, seed=seed, **overrides)
    if checkpoint is not None:
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        model.load_state_dict(reference_state_dict(ckpt))
    return model
