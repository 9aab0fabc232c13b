"""Weight-norm folding for serving (the reference's ``remove_weight_norm``).

Every weight-normed conv of a model holds ``weight_v`` and ``weight_g`` and
resolves ``g * v / ||v||`` at every call (``nn/conv.py``; per out-channel for
a conv, per in-channel for a conv-transpose, dimension 0 of the torch
layout either way). Folding stores that product once as a plain ``weight``
and sets the conv's norm to ``"none"``, which removes the five operations of
weight norm per conv and call; outputs are equal up to float rounding.
The codebooks carry no weight norm and pass through untouched.

The port's counterpart of academicodec_tpu/utils/fold.py:61-86, on models
that hold their weights (the JAX functions take and return a variable tree).
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from academicodec_tpu_torch.nn.conv import _NormedWeight


def fold_weight_norm(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose weight-normed convs hold their resolved
    weight as a plain ``weight`` (``norm="none"``)."""
    folded = copy.deepcopy(model)
    for m in folded.modules():
        if isinstance(m, _NormedWeight) and m.norm == "weight_norm":
            with torch.no_grad():
                w = m.resolved_weight().detach().clone()
            del m.weight_v, m.weight_g
            m.weight = nn.Parameter(w)
            m.norm = "none"
    return folded


def fold_vqvae(model):
    """HiFi-Codec ``VQVAE`` -> a copy with every encoder and generator conv
    folded (reference models.py:112-124, 177-188; vqvae_copy_syn.py:33)."""
    return fold_weight_norm(model)


def fold_soundstream(model):
    """SoundStream/Encodec -> a copy with every SEANet conv folded."""
    return fold_weight_norm(model)
