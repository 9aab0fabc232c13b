"""The codec entry for a factorized, L2-normalized RVQ (DAC's): the same calls, DAC's own check.

Everything but ``prepare`` and ``judge`` is :mod:`portbench.entries.codec`'s,
imported unchanged: the traffic keys, the call from host memory to host
outputs, the reference on the run's device, the controls, the model FLOPs.

``prepare`` is the codec entry's with one step more: the family's Snake
alphas are set (``set_alphas``) right after the seeded weights, before the
reference computes the latents that the codebooks spread over.

``judge``: ``compare.code_gaps`` cannot follow a chain of Euclidean residuals
in one space through DAC's quantizer, whose every layer projects the
residual anew and searches by cosine; a chain that followed the reference's
own codes would turn every bf16 near-tie into a large gap at the next layer.
So the reference computes, along the program's own codes, each layer's
projection ``p_i`` of the residual (``Reference.projections``), and
``code_gaps`` takes them as one layer of ``n_codebooks`` groups: latents
``[N, n x codebook_dim]``, codes ``[N, n]``, books ``[n, K, codebook_dim]``:
layer ``i``'s normalized codebook times ``s_i``, the root mean square of
``|p_i|`` over the call's frames. Rows of one length rank as their cosines
to ``p_i`` do, so each group is exactly DAC's decision at that layer, judged
by the reference's f32 numbers; a chosen row's excess is ``2 s_i |p_i|
(cos_best - cos_chosen)``, a margin in the projection's own units, which the
program's rounding of ``p_i`` moves by the same amount at any ``|p_i|``. (Unit
vectors would weigh every layer alike, and turn a layer of short projections
by its rounding over its length: at the benchmark's seeded weights the first
layer's are ~10x shorter than the others', and there the program's bf16
towers read as far from the reference as one moved token does.) ``wav_err``
and ``wav_dc`` are the codec entry's.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import compare, inputs
from portbench.entries.codec import (  # noqa: F401
    DTYPES, _frames_of, audio_seconds, by_length, call, control_outputs, kernel_bounds, model_flops, reference,
    release, tf32,
)


def prepare(ctx) -> None:
    """Weights, Snake alphas, codebooks and clips from the seed; the program built on them."""
    fam, cfg, traffic = ctx.family, ctx.config, ctx.traffic
    sr = fam.sample_rate(cfg)
    sd = inputs.seeded_state_dict(fam.specs(cfg), ctx.seed, ctx.device)
    fam.set_alphas(sd)
    ctx.state["batches"] = inputs.seeded_batches(traffic, sr, ctx.seed, ctx.device)
    wav0, lens0 = ctx.state["batches"][0]
    with torch.no_grad(), tf32(False):  # codebooks over the reference's latents of two clips
        first = [wav0[b:b + 1, : int(lens0[b])].to(ctx.device) for b in range(min(2, len(lens0)))]
        frames = torch.cat([fam.Reference(cfg, sd).latents(w) for w in first])
    fam.set_codebooks(cfg, sd, frames, ctx.seed + 2)
    ctx.state["program"] = fam.build_program(cfg, sd, DTYPES[traffic["dtype"]], ctx.device)
    ctx.state["weights"] = {k: v.cpu() for k, v in sd.items()}  # off the device while the program runs


def judge(ctx, i: int, outputs, ref=None) -> Dict[str, float]:
    """Call ``i``'s outputs held against the f32 reference (module docstring)."""
    fam, cfg = ctx.family, ctx.config
    codes, wav_out = outputs
    wav, lengths = ctx.state["batches"][i % len(ctx.state["batches"])]
    ref = ref or reference(ctx)
    frames = [fam.frames_for(cfg, int(n)) for n in lengths]
    with torch.no_grad(), tf32(False):
        z = torch.cat(by_length(ref.latents, wav, lengths, ctx.device, _frames_of))
        if z.shape[0] != sum(frames):
            raise ValueError(f"the reference gives {z.shape[0]} frames, the layout {sum(frames)}")
        chosen = torch.cat(fam.codes_by_layer(codes, list(range(len(lengths))), frames), dim=1).to(ctx.device)
        p = ref.projections(z, chosen)
        scales = p.view(p.shape[0], chosen.shape[1], -1).square().sum(-1).mean(0).sqrt()
        out = compare.code_gaps(p, ref.books_for_search(scales), [chosen], frames)
        if wav_out is not None:
            plain = reference(ctx, dtype=torch.bfloat16)
            c = codes.to(ctx.device)
            f32, bf16 = ref.decode(c), plain.decode(c)
            out["wav_err"] = compare.wav_err(wav_out, f32, bf16)
            out["wav_dc"] = compare.wav_dc(wav_out, f32, bf16)
    return out
