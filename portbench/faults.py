"""Faults a roundtrip or tokenization call can have, planted in its outputs.

The check must find each: ``tests/test_portbench_faults.py`` drives whole
runs with them on the CPU, and ``control.py --faults`` reads them on the
card at the cell's own size. Each takes the run's context and one call's
outputs ``(codes, wav or None)``.
"""

from __future__ import annotations

import torch


def half_batch(ctx, out):
    """Half of the batch left out: its rows answered with the other half's."""
    fam = ctx.family
    codes, wav = out
    codes = codes.clone()
    half = codes.shape[fam.BATCH_AXIS] // 2
    codes.narrow(fam.BATCH_AXIS, half, half).copy_(codes.narrow(fam.BATCH_AXIS, 0, half))
    if wav is not None:
        wav = wav.clone()
        wav[half:2 * half] = wav[:half]
    return codes, wav


def token_altered(ctx, out):
    """One token of the first codebook, in the middle of the first clip, moved to the next row."""
    fam = ctx.family
    codes, wav = out
    codes = codes.clone()
    index = [0] * codes.dim()
    index[fam.TIME_AXIS] = codes.shape[fam.TIME_AXIS] // 4
    index = tuple(index)
    codes[index] = (codes[index] + 1) % fam.codebook_size(ctx.config)
    return codes, wav


def sample_altered(ctx, out):
    """One decoded sample in the middle of the first clip moved by half the clip's peak."""
    codes, wav = out
    wav = wav.clone()
    wav[0, wav.shape[1] // 2] += 0.5 * wav[0].abs().max()
    return codes, wav


def post_bias_dropped(ctx, out):
    """The decoded wav without the bias of the decoder's last conv: the reference's
    f32 decode of the call's own codes, that bias set to zero."""
    codes, _ = out
    weights = dict(ctx.state["weights"])
    key = ctx.family.post_bias(ctx.config)
    weights[key] = torch.zeros_like(weights[key])
    ref = ctx.family.Reference(ctx.config, {k: v.to(ctx.device) for k, v in weights.items()})
    with torch.no_grad():
        wav = ref.decode(codes.to(ctx.device))
    return codes, wav.float().cpu()


FAULTS = {"half_batch": half_batch, "token_altered": token_altered, "sample_altered": sample_altered,
          "post_bias_dropped": post_bias_dropped}
DECODED = ("sample_altered", "post_bias_dropped")  # faults of the decoded wav, for cells that decode
