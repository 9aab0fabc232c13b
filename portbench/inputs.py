"""Everything a run feeds both sides, made from ``--seed``: weights, codebooks, clips.

The weights are a reference-layout ``state_dict`` drawn on the run's device
in one call per distribution (:func:`seeded_state_dict`); the program loads
it through its public loaders and the reference reads the same tensors.
The clips are noise x0.1 (a frozen copy of ``chip_smoke.seeded_wav``'s
signal), each zero-padded to the traffic's bucket. :func:`spread_codebooks`
is a frozen copy of ``chip_smoke.spread_codebooks``: the codebooks follow
the latent frames that the reference computes, so that tokens spread.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Specs = Dict[str, Tuple[Tuple[int, ...], str, int]]

def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def seeded_state_dict(specs: Specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 tensors for every entry of ``specs``: ``uniform`` ones U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (torch's default init), ``norm_of_v`` the per-channel norm of the matching ``weight_v`` (so that the
    resolved weight equals ``v``), ``zeros``/``ones`` constant, and ``codebook``
    rows N(0, 1) until :func:`spread_codebooks` replaces them."""
    g = generator(seed, device)
    sizes = {kind: sum(math.prod(s) for s, k, _ in specs.values() if k == kind)
             for kind in ("uniform", "codebook")}
    pools = {
        "uniform": torch.rand(sizes["uniform"], generator=g, device=device).mul_(2.0).sub_(1.0),
        "codebook": torch.randn(sizes["codebook"], generator=g, device=device),
    }
    offsets = dict.fromkeys(pools, 0)
    sd: Dict[str, torch.Tensor] = {}
    for name, (shape, kind, fan_in) in specs.items():
        n = math.prod(shape)
        if kind in pools:
            t = pools[kind][offsets[kind]: offsets[kind] + n].view(shape)
            offsets[kind] += n
            sd[name] = t * (1.0 / math.sqrt(fan_in)) if kind == "uniform" else t
        elif kind == "zeros":
            sd[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            sd[name] = torch.ones(shape, device=device)
    for name, (shape, kind, _) in specs.items():
        if kind == "norm_of_v":
            v = sd[name[: -len("weight_g")] + "weight_v"]
            sd[name] = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return {name: sd[name] for name in specs}


def spread_codebooks(frames: torch.Tensor, layers: int, groups: int, codes: int, seed: int) -> torch.Tensor:
    """Codebooks ``[layers, groups, codes, D / groups]`` that follow ``frames [N, D]``:
    layer 0 entries are frames picked at random plus N(0, (0.1 s)^2) noise, each
    later layer's a quarter of the difference of two random frames; ``s`` is
    the frames' std."""
    g = generator(seed, frames.device)
    N, D = frames.shape
    s = frames.std()

    def pick():
        idx = torch.randint(N, (codes,), generator=g, device=frames.device)
        return frames[idx].reshape(codes, groups, D // groups).transpose(0, 1)

    noise = torch.randn((groups, codes, D // groups), generator=g, device=frames.device)
    books = [pick() + noise * (0.1 * s)]
    books += [(pick() - pick()) * 0.25 for _ in range(layers - 1)]
    return torch.stack(books)


def clip_lengths(traffic: dict, sample_rate: int) -> List[int]:
    """One batch's clip lengths in samples: ``batch`` lengths evenly spaced over
    ``clip_seconds [lo, hi]`` (all ``hi`` when they are equal). Every batch of
    every seed holds this same set; the seed only orders it."""
    lo, hi = traffic["clip_seconds"]
    B = traffic["batch"]
    return [int(round((lo + (hi - lo) * (i + 0.5) / B if hi > lo else hi) * sample_rate)) for i in range(B)]


def seeded_batches(traffic: dict, sample_rate: int, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``traffic['batches']`` host batches ``(wav [B, bucket] f32, lengths [B] int64)``:
    noise x0.1 drawn on ``device``, zero past each clip's length, rows in a
    seeded order of :func:`clip_lengths`."""
    g = generator(seed + 1, device)
    bucket = int(round(traffic["bucket_seconds"] * sample_rate))
    lengths = torch.tensor(clip_lengths(traffic, sample_rate), dtype=torch.long)
    if int(lengths.max()) > bucket:
        raise ValueError(f"clips of up to {int(lengths.max())} samples do not fit the bucket of {bucket}")
    out = []
    for _ in range(traffic["batches"]):
        order = torch.randperm(len(lengths), generator=g, device=device).cpu()
        lens = lengths[order]
        wav = torch.randn((len(lens), bucket), generator=g, device=device) * 0.1
        wav *= (torch.arange(bucket, device=device)[None, :] < lens.to(device)[:, None])
        out.append((wav.cpu(), lens))
    return out
