"""Group-residual vector quantization (GRVQ), the HiFi-Codec quantizer; inference only.

``n_residual`` residual layers, each splitting the channels into ``n_groups``
groups with their own codebook. All codebooks live in one stacked buffer
``codebooks [n_res, G, K, D / G]``. Tokens come in the stream order that
VALL-E/SoundStorm consume: ``[l0 g0, l0 g1, l1 g0, l1 g1]``.

The search is ``argmin(|x|^2 + |e|^2 - 2 x.e)`` in f32 (lowest index on
ties) with ``torch.matmul``: the JAX package computes it in XLA, outside any
Pallas kernel. The residual update repeats the JAX arithmetic
``r - (r + (z - r))`` of its straight-through form, so tokens of later
layers match exactly.

State-dict keys follow the reference ``Quantizer``:
``quantizer_modules.{g}.embedding.weight`` (layer 0) and
``quantizer_modules2.{g}.embedding.weight`` (layer 1).

Behavioral parity target: academicodec_tpu/quant/grvq.py:27-113 (reference
models/hificodec/models.py:430-535).
"""

from __future__ import annotations

import torch
import torch.nn as nn

_LAYER_PREFIX = ("quantizer_modules", "quantizer_modules2")


class GroupResidualVQ(nn.Module):
    def __init__(self, dim: int = 512, n_codes: int = 1024, n_groups: int = 2, n_residual: int = 2):
        super().__init__()
        if dim % n_groups:
            raise ValueError(f"dim {dim} is not a multiple of n_groups {n_groups}")
        if n_residual > len(_LAYER_PREFIX):
            raise ValueError(f"the reference checkpoint layout has {len(_LAYER_PREFIX)} residual layers")
        self.dim, self.n_codes, self.n_groups, self.n_residual = dim, n_codes, n_groups, n_residual
        self.register_buffer("codebooks", torch.zeros(n_residual, n_groups, n_codes, dim // n_groups))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference ``nn.Embedding`` init: uniform(-1/n_codes, 1/n_codes)."""
        bound = 1.0 / self.n_codes
        with torch.no_grad():
            self.codebooks.copy_(
                torch.empty(self.codebooks.shape).uniform_(-bound, bound, generator=generator)
            )

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, T, D]`` -> codes ``[B, T, n_res * G]`` int32."""
        B, T, D = x.shape
        G = self.n_groups
        residual = x.float().reshape(B * T, G, D // G)
        codes = []
        for layer in self.codebooks.float():
            dots = torch.einsum("ngd,gkd->ngk", residual, layer)
            dist = residual.square().sum(dim=-1, keepdim=True) + layer.square().sum(dim=-1)[None] - 2.0 * dots
            idx = dist.argmin(dim=-1)  # [B*T, G], the first index on ties
            z_q = torch.stack([layer[g][idx[:, g]] for g in range(G)], dim=1)
            residual = residual - (residual + (z_q - residual))
            codes.append(idx.to(torch.int32))
        return torch.cat(codes, dim=-1).reshape(B, T, self.n_residual * G)

    def embed(self, codes: torch.Tensor) -> torch.Tensor:
        """Tokens ``[B, T, n_res * G]`` -> ``[B, T, D]`` in the codebooks' dtype."""
        B, T, _ = codes.shape
        G = self.n_groups
        codes = codes.long()
        out = torch.zeros((B, T, self.dim), dtype=self.codebooks.dtype, device=self.codebooks.device)
        for i in range(self.n_residual):
            parts = [self.codebooks[i, g][codes[..., i * G + g]] for g in range(G)]
            out = out + torch.cat(parts, dim=-1)
        return out

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for i in range(self.n_residual):
            for g in range(self.n_groups):
                e = self.codebooks[i, g]
                destination[f"{prefix}{_LAYER_PREFIX[i]}.{g}.embedding.weight"] = e if keep_vars else e.detach()

    def _load_from_state_dict(
        self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys, error_msgs
    ):
        expected = set()
        with torch.no_grad():
            for i in range(self.n_residual):
                for g in range(self.n_groups):
                    key = f"{prefix}{_LAYER_PREFIX[i]}.{g}.embedding.weight"
                    expected.add(key)
                    if key not in state_dict:
                        missing_keys.append(key)
                    elif tuple(state_dict[key].shape) != tuple(self.codebooks.shape[2:]):
                        error_msgs.append(
                            f"size mismatch for {key}: {tuple(state_dict[key].shape)} "
                            f"vs {tuple(self.codebooks.shape[2:])}"
                        )
                    else:
                        self.codebooks[i, g].copy_(state_dict[key])
        unexpected_keys.extend(k for k in state_dict if k.startswith(prefix) and k not in expected)
