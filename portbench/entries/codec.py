"""The codec entry: a batch of clips through the program's ``encode`` (and ``decode``).

Traffic keys it reads:

* ``batch``, ``clip_seconds [lo, hi]``, ``bucket_seconds``, ``batches``: the
  clips (:func:`portbench.inputs.seeded_batches`); every call takes the next
  of ``batches`` host batches in turn;
* ``lengths``: pass each clip's valid length to ``encode(wav, lengths=)``
  (the length-masked encode of a zero-padded batch), else ``encode(wav)``;
* ``decode``: decode the codes back to a wav in the same call;
* ``dtype``: the model's weights and activations.

A call ends with its outputs on the host: the codes, and the decoded wav
(f32) where it decodes. Audio seconds count each clip's valid length.

``judge`` holds one call's outputs against the reference (f32, TF32 off,
on the run's device): ``code_gap``, ``code_mean`` and ``clip_mean`` over every
clip's valid frames, the reference encoding each clip at its own length, and
with ``decode`` ``wav_err`` and ``wav_dc``, the reference decoding the
program's own codes, in f32 and as a plain bf16 computation
(:mod:`portbench.compare`). The cell's limits file
names the numbers compared.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from portbench import bounds, compare, inputs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def prepare(ctx) -> None:
    """Weights, codebooks and clips from the seed; the program built on them."""
    fam, cfg, traffic = ctx.family, ctx.config, ctx.traffic
    sr = fam.sample_rate(cfg)
    sd = inputs.seeded_state_dict(fam.specs(cfg), ctx.seed, ctx.device)
    ctx.state["batches"] = inputs.seeded_batches(traffic, sr, ctx.seed, ctx.device)
    wav0, lens0 = ctx.state["batches"][0]
    with torch.no_grad(), tf32(False):  # codebooks over the reference's latents of two clips
        first = [wav0[b:b + 1, : int(lens0[b])].to(ctx.device) for b in range(min(2, len(lens0)))]
        frames = torch.cat([fam.Reference(cfg, sd).latents(w) for w in first])
    fam.set_codebooks(cfg, sd, frames, ctx.seed + 2)
    ctx.state["program"] = fam.build_program(cfg, sd, DTYPES[traffic["dtype"]], ctx.device)
    ctx.state["weights"] = {k: v.cpu() for k, v in sd.items()}  # off the device while the program runs


def call(ctx, i: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Call ``i``: batch ``i mod batches`` from host memory -> host codes (and wav)."""
    model, traffic = ctx.state["program"], ctx.traffic
    wav, lengths = ctx.state["batches"][i % len(ctx.state["batches"])]
    with record_function("portbench.encode"):
        codes = model.encode(wav, lengths=lengths) if traffic["lengths"] else model.encode(wav)
    out = None
    if traffic["decode"]:
        with record_function("portbench.decode"):
            out = model.decode(codes)
    with record_function("portbench.to_host"):
        return codes.cpu(), (None if out is None else out.float().cpu())


def audio_seconds(ctx, i: int) -> float:
    _, lengths = ctx.state["batches"][i % len(ctx.state["batches"])]
    return float(lengths.sum()) / ctx.family.sample_rate(ctx.config)


def release(ctx) -> None:
    """Free the program and what it holds on the device."""
    ctx.state.pop("program", None)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class tf32:
    """TF32 in cuDNN convs and matmuls on or off inside the block, restored after it."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def reference(ctx, cast=None, dtype=torch.float32):
    """The reference on the run's device, over the run's weights."""
    weights = {k: v.to(ctx.device) for k, v in ctx.state["weights"].items()}
    return ctx.family.Reference(ctx.config, weights, cast, dtype)


def judge(ctx, i: int, outputs, ref=None) -> Dict[str, float]:
    """Call ``i``'s outputs held against the f32 reference (module docstring)."""
    fam, cfg = ctx.family, ctx.config
    codes, wav_out = outputs
    wav, lengths = ctx.state["batches"][i % len(ctx.state["batches"])]
    ref = ref or reference(ctx)
    rows = list(range(len(lengths)))
    frames = [fam.frames_for(cfg, int(n)) for n in lengths]
    with torch.no_grad(), tf32(False):
        latents = torch.cat(by_length(ref.latents, wav, lengths, ctx.device, _frames_of))
        if latents.shape[0] != sum(frames):
            raise ValueError(f"the reference gives {latents.shape[0]} frames, the layout {sum(frames)}")
        out = compare.code_gaps(latents, ref.books_for_search(), fam.codes_by_layer(codes, rows, frames), frames)
        if wav_out is not None:
            plain = reference(ctx, dtype=torch.bfloat16)
            c = codes.to(ctx.device)
            f32, bf16 = ref.decode(c), plain.decode(c)
            out["wav_err"] = compare.wav_err(wav_out, f32, bf16)
            out["wav_dc"] = compare.wav_dc(wav_out, f32, bf16)
    return out


def by_length(fn, wav: torch.Tensor, lengths: torch.Tensor, device, split) -> list:
    """``fn`` over each clip at its own length, the clips of one length in one
    batch -> one result a clip in row order; ``split(result, j, count)`` takes
    the ``j``-th of ``count`` clips out of a batch's result."""
    out = [None] * len(lengths)
    for n in sorted(set(int(v) for v in lengths)):
        rows = [b for b in range(len(lengths)) if int(lengths[b]) == n]
        result = fn(wav[rows, :n].to(device))
        for j, b in enumerate(rows):
            out[b] = split(result, j, len(rows))
    return out


def _frames_of(z: torch.Tensor, j: int, count: int) -> torch.Tensor:
    f = z.shape[0] // count
    return z[j * f:(j + 1) * f]


def control_outputs(ctx, i: int, cast=None, tf32_on: bool = False):
    """The reference in the program's place (the controls of ``portbench/control.py``):
    call ``i``'s outputs in the program's layout, from the reference computed with
    ``cast`` rounding every conv and matmul operand, or with TF32 on."""
    fam, cfg, traffic = ctx.family, ctx.config, ctx.traffic
    wav, lengths = ctx.state["batches"][i % len(ctx.state["batches"])]
    ref = reference(ctx, cast)
    with torch.no_grad(), tf32(tf32_on):
        per_row = by_length(ref.encode, wav, lengths, ctx.device, lambda c, j, _: fam.row_slice(c, j, j + 1))
        codes = fam.join_rows(per_row, fam.frames_for(cfg, wav.shape[1]))
        out = ref.decode(codes) if traffic["decode"] else None
    return codes.cpu(), (None if out is None else out.float().cpu())


def model_flops(ctx, i: int) -> float:
    """Operations of call ``i`` by the reference's math, counted on meta tensors at
    each clip's valid length: encode, the codebook search and, with ``decode``, decode."""
    fam, cfg = ctx.family, ctx.config
    _, lengths = ctx.state["batches"][i % len(ctx.state["batches"])]
    ref = fam.Reference(cfg, bounds.meta_state_dict(fam.specs(cfg)))
    per_length = {}
    for n in set(int(v) for v in lengths):
        wav = torch.empty((1, n), device="meta")
        per_length[n] = bounds.count_flops(lambda: _search_and_decode(ctx, ref, wav))
    return sum(per_length[int(v)] for v in lengths)


def _search_and_decode(ctx, ref, wav):
    codes = ref.encode(wav)
    if ctx.traffic["decode"]:
        ref.decode(codes)


def kernel_bounds(ctx, i: int) -> Dict[str, List[float]]:
    """The least time (ms) of each hand-written kernel call that call ``i`` makes."""
    wav, lengths = ctx.state["batches"][i % len(ctx.state["batches"])]
    traffic = ctx.traffic
    return ctx.family.kernel_calls(ctx.config, wav.shape[0], wav.shape[1], traffic["dtype"], traffic["decode"],
                                   [int(n) for n in lengths] if traffic["lengths"] else None)
