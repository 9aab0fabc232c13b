"""GAN losses over discriminator outputs.

A discriminator family returns ``(logits, fmaps)``: one logits tensor per
sub-discriminator and one list of feature maps per sub-discriminator. The
losses reduce with means, so they do not depend on the layout (the port's
maps are channels-first, the JAX package's channels-last).

Two adversarial families, as in the JAX package (academicodec_tpu/losses/gan.py:18-91):
hinge (Encodec/SoundStream, reference models/encodec/loss.py:6-29, 87-108)
and least squares (HiFi-Codec, reference models/hificodec/models.py:330-361).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Maps = Sequence[Sequence[torch.Tensor]]


def hinge_adversarial_g_loss(logits_gen: Sequence[torch.Tensor]) -> torch.Tensor:
    """``mean_i mean(relu(1 - D_i(G(x))))``."""
    return sum(torch.relu(1.0 - lg).mean() for lg in logits_gen) / len(logits_gen)


def hinge_discriminator_loss(logits_real: Sequence[torch.Tensor], logits_gen: Sequence[torch.Tensor]) -> torch.Tensor:
    """``mean_i [mean(relu(1 - D_i(x))) + mean(relu(1 + D_i(G(x))))]``."""
    loss = sum(torch.relu(1.0 - lr).mean() + torch.relu(1.0 + lg).mean() for lr, lg in zip(logits_real, logits_gen))
    return loss / len(logits_real)


def relative_feature_loss(fmap_real: Maps, fmap_gen: Maps) -> torch.Tensor:
    """Mean over (i, j) of ``mean(|r - g| / mean|r|)``."""
    loss = sum(
        ((r - g).abs() / r.abs().mean()).mean() for fr, fg in zip(fmap_real, fmap_gen) for r, g in zip(fr, fg)
    )
    return loss / (len(fmap_real) * len(fmap_real[0]))


def absolute_feature_loss(fmap_real: Maps, fmap_gen: Maps) -> torch.Tensor:
    """``2 * sum mean|r - g|`` (the HiFi-GAN flavor)."""
    return 2.0 * sum((r - g).abs().mean() for fr, fg in zip(fmap_real, fmap_gen) for r, g in zip(fr, fg))


def sim_loss(logits_real: Sequence[torch.Tensor], logits_gen: Sequence[torch.Tensor]) -> torch.Tensor:
    """``mean_i MSE(D_i(x), D_i(G(x)))``."""
    return sum((lr - lg).square().mean() for lr, lg in zip(logits_real, logits_gen)) / len(logits_real)


def ls_generator_loss(logits_gen: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LS-GAN generator loss ``sum mean((1 - D_i)^2)`` and its terms."""
    losses = [(1.0 - lg).square().mean() for lg in logits_gen]
    return sum(losses), losses


def ls_discriminator_loss(
    logits_real: Sequence[torch.Tensor], logits_gen: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """LS-GAN discriminator loss and its real and generated terms."""
    r_losses = [(1.0 - lr).square().mean() for lr in logits_real]
    g_losses = [lg.square().mean() for lg in logits_gen]
    return sum(r_losses) + sum(g_losses), r_losses, g_losses


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0) -> float:
    """Warm-up gate: ``value`` until ``global_step >= threshold``, then ``weight``."""
    return value if global_step < threshold else weight
