"""The Descript Audio Codec's factorized, L2-normalized residual vector quantizer.

DAC's ``ResidualVectorQuantize`` (dac/nn/quantize.py), served: for each of
``n_codebooks`` layers, with the residual ``r`` (``input_dim`` wide; the
encoder's latent at the first layer)

    p = in_proj(r)                          a 1x1 weight-normed conv, input_dim -> codebook_dim, with a bias
    code = argmin |p^ - c^_k|^2             p^, c^_k: F.normalize'd (eps 1e-12), the cosine-nearest row
    q = out_proj(codebook[code])            the unnormalized row, codebook_dim -> input_dim, with a bias
    r = r - q

with the distance written as DAC writes it, ``|p^|^2 - 2 p^.c^ + |c^|^2``, and
the lowest index on ties. Decoding sums the layers' ``q``. K1 cannot run it:
every layer projects the residual anew and searches in the projection's 8
normalized dims, where K1 fuses a Euclidean chain in one space. The work is
small (a 10 s clip at 44.1 kHz is 862 frames), so it is plain torch: two
products a layer and the search's ``[N, K]`` distances.

Everything is f32, whatever the towers' dtype, as the port's other searches
are: the model keeps this module in f32. Frames come as rows ``[N, input_dim]``.
State-dict keys are DAC's: ``quantizers.{i}.in_proj.weight_v`` / ``weight_g`` /
``bias``, ``out_proj...``, ``codebook.weight`` (codebooks as plain tables).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.nn.conv import Conv1d


def nearest_normalized(p: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Row of ``codebook [K, d]`` cosine-nearest each row of ``p [N, d]``, as DAC
    computes it on normalized vectors (lowest index on ties) -> ``[N]`` int64."""
    e, c = F.normalize(p), F.normalize(codebook)
    dist = e.pow(2).sum(1, keepdim=True) - 2 * e @ c.t() + c.pow(2).sum(1, keepdim=True).t()
    return dist.argmin(dim=1)


def _linear(proj: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on rows ``[N, in]`` -> ``[N, out]``."""
    return F.linear(x, proj.resolved_weight()[:, :, 0], proj.bias)


class FactorizedVQ(nn.Module):
    """One layer: DAC's ``VectorQuantize``."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.in_proj = Conv1d(input_dim, codebook_dim, 1, norm="weight_norm")
        self.out_proj = Conv1d(codebook_dim, input_dim, 1, norm="weight_norm")
        self.codebook = nn.Embedding(codebook_size, codebook_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Torch's uniform init for the projections, N(0, 1) codebook rows."""
        self.in_proj.reset_parameters(generator)
        self.out_proj.reset_parameters(generator)
        with torch.no_grad():
            self.codebook.weight.copy_(torch.randn(self.codebook.weight.shape, generator=generator))


class FactorizedRVQ(nn.Module):
    """DAC's ``ResidualVectorQuantize`` (module docstring): codes ``[n_q, N]`` int32."""

    def __init__(self, input_dim: int = 1024, n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: int = 8):
        super().__init__()
        self.n_q, self.bins = n_codebooks, codebook_size
        self.quantizers = nn.ModuleList(
            FactorizedVQ(input_dim, codebook_size, codebook_dim) for _ in range(n_codebooks))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for q in self.quantizers:
            q.reset_parameters(generator)

    def encode(self, z: torch.Tensor, n_q: Optional[int] = None) -> torch.Tensor:
        """Latent rows ``z [N, input_dim]`` -> codes ``[n_q, N]`` int32 (all layers for None)."""
        n_q = self.n_q if n_q is None else int(n_q)
        if not 1 <= n_q <= self.n_q:
            raise ValueError(f"n_q {n_q} outside 1..{self.n_q}")
        r = z.float()
        codes = []
        for q in self.quantizers[:n_q]:
            idx = nearest_normalized(_linear(q.in_proj, r), q.codebook.weight)
            codes.append(idx.to(torch.int32))
            r = r - _linear(q.out_proj, q.codebook.weight[idx])
        return torch.stack(codes)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[n, N]`` -> ``[N, input_dim]`` f32: the first ``n`` layers' ``q``
        summed, as one product of the chosen rows side by side."""
        layers = self.quantizers[: codes.shape[0]]
        rows = torch.cat([q.codebook.weight[c.long()] for q, c in zip(layers, codes)], dim=1)
        w = torch.cat([q.out_proj.resolved_weight()[:, :, 0] for q in layers], dim=1)
        return F.linear(rows, w, sum(q.out_proj.bias for q in layers))
