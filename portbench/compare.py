"""The numbers that decide ``correct``: how far the program's answers lie from the reference's.

``code_gap``: the codebook search judged by the reference. Following the
program's own codes layer by layer (the residual after each layer is the
reference latent minus the rows the program chose), each chosen row's
squared distance to the residual is set against the nearest row's, both
from the reference's f32 latent and codebooks. The widest excess over all
frames, layers and groups, over the frames' spread (the mean squared
distance of a latent frame from the mean frame, which sets how far apart
codebook rows lie), is ``code_gap``: 0 where every choice is the reference's nearest, small
where a choice differs only at a near-tie, large where a token is wrong.
``code_mean`` is the mean excess over every token, and ``clip_mean`` that
mean over each clip's tokens alone, the worst clip's: a clip answered with
another clip's tokens moves its own mean far more than rounding does, where
the batch's mean thins it out over the clips answered rightly.

``wav_err``: the decoded wav, judged on the same codes. Its error against
the reference's f32 decode is the largest absolute difference of the AC
parts (each row less its mean) over the largest absolute AC reference
sample, the worst row's; ``wav_err`` is that of the program over that of a
plain bf16 computation of the reference on the same codes. A seed's
weights set how far rounding anywhere reaches the output (the raw error of
the program, of bf16 and of fp8 alike move 10x from seed to seed, together),
and the random-weight decoders put out a large constant offset whose
rounding says nothing of the signal; the ratio is steady (about 1 for a
sound bf16 program) where the raw error is not.

``wav_dc``: what ``wav_err`` leaves out, the offset. The largest difference
of a row's mean from the reference's, over the largest absolute AC
reference sample, in units of the plain bf16 computation's ``ac_err``: a
bias dropped or doubled in front of the output shifts whole rows, where
rounding's errors average out over a clip's samples.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def code_gaps(latents: torch.Tensor, books: Sequence[torch.Tensor], codes: Sequence[torch.Tensor],
              clip_frames: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """``latents [N, D]`` f32; ``books``: each layer's codebooks ``[G, K, D / G]``;
    ``codes``: each layer's chosen rows ``[N, G]``, in the same order;
    ``clip_frames``: the frames of each clip, in row order (one clip if None) ->
    ``{code_gap, code_mean, clip_mean}``: the widest excess, the mean over every
    token and the worst clip's mean over its tokens."""
    N, D = latents.shape
    G = books[0].shape[0]
    r = latents.float().reshape(N, G, D // G)
    z = latents.float()
    scale = (z - z.mean(dim=0)).square().sum(dim=1).mean()
    worst = torch.zeros((), device=latents.device)
    per_frame = torch.zeros(N, dtype=torch.float64, device=latents.device)
    for book, idx in zip(books, codes):
        idx = idx.to(latents.device).long().reshape(N, G)
        chosen_rows = []
        for g in range(G):
            rg, e = r[:, g], book[g].float()
            best = (rg.square().sum(1, keepdim=True) - 2.0 * rg @ e.t() + e.square().sum(1)).argmin(dim=1)
            d_best = (rg - e[best]).square().sum(1)
            d_chosen = (rg - e[idx[:, g]]).square().sum(1)
            excess = (d_chosen - d_best).clamp(min=0.0)
            worst = torch.maximum(worst, excess.max())
            per_frame += excess.double()
            chosen_rows.append(e[idx[:, g]])
        r = r - torch.stack(chosen_rows, dim=1)
    norm = len(books) * G * float(scale)  # tokens a frame, and the frames' spread
    clip_mean = max(float(c.mean()) for c in per_frame.split(list(clip_frames or [N])))
    return {"code_gap": float(worst / scale), "code_mean": float(per_frame.mean()) / norm,
            "clip_mean": clip_mean / norm}


def ac_err(wav: torch.Tensor, reference: torch.Tensor) -> float:
    """max over rows of max |AC(wav - reference)| / max |AC(reference)|, AC = less the row's mean."""
    ref = reference.float()
    d = wav.to(ref.device).float() - ref
    d = d - d.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    return float((d.abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max())


def wav_err(program: torch.Tensor, reference: torch.Tensor, plain_bf16: torch.Tensor) -> float:
    """The program's ``ac_err`` over the plain bf16 decode's, both against the f32 reference."""
    return ac_err(program, reference) / ac_err(plain_bf16, reference)


def wav_dc(program: torch.Tensor, reference: torch.Tensor, plain_bf16: torch.Tensor) -> float:
    """max over rows of |mean(program - reference)| / max |AC(reference)|, over the
    plain bf16 decode's ``ac_err``, both against the f32 reference."""
    ref = reference.float()
    d = (program.to(ref.device).float() - ref).mean(dim=-1).abs()
    peak = (ref - ref.mean(dim=-1, keepdim=True)).abs().amax(dim=-1)
    return float((d / peak).max()) / ac_err(plain_bf16, reference)
