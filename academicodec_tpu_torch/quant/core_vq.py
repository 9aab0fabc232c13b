"""Residual vector quantization, inference paths.

All ``n_q`` codebooks live in one stacked ``embed [n_q, K, D]`` buffer.
``encode`` is greedy residual quantization through ``ops/cuda/rvq``: the
fused kernel for CUDA tensors, the plain version for CPU tensors. ``decode``
is one gather from the flattened codebook and a sum over layers.

State-dict keys follow the reference, one ``layers.{i}._codebook.embed``
per layer: loading folds them into the stacked buffer. The reference's EMA
statistics (``embed_avg``, ``cluster_size``, ``inited``) are accepted and
dropped, since only training reads them; EMA updates, k-means init and
dead-code expiry come with the training port.

Behavioral parity target: academicodec_tpu/quant/core_vq.py:50-62, 288-320.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from academicodec_tpu_torch.ops.cuda.rvq import l2_distance_argmin, rvq_encode

__all__ = ["ResidualVQ", "l2_distance_argmin"]

_EMA_KEYS = ("embed_avg", "cluster_size", "inited")


class ResidualVQ(nn.Module):
    """Stack of codebooks applied to the residual; layout ``[B, T, D]``."""

    def __init__(self, num_quantizers: int, dim: int, codebook_size: int = 1024):
        super().__init__()
        self.num_quantizers, self.dim, self.codebook_size = num_quantizers, dim, codebook_size
        self.register_buffer("embed", torch.zeros(num_quantizers, codebook_size, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1) codebooks: random but non-degenerate, so the search does real work."""
        with torch.no_grad():
            self.embed.copy_(torch.randn(self.embed.shape, generator=generator))

    def encode(self, x: torch.Tensor, n_q: Optional[int] = None, st: int = 0) -> torch.Tensor:
        """``x [B, T, D]`` -> codes ``[n_q - st, B, T]`` int32 (layers ``st .. n_q-1``,
        starting from ``x`` itself as in the reference)."""
        n_q = n_q or self.num_quantizers
        B, T, D = x.shape
        codes = rvq_encode(x.reshape(B * T, D), self.embed[st:n_q])
        return codes.reshape(-1, B, T)

    def decode(self, codes: torch.Tensor, st: int = 0) -> torch.Tensor:
        """codes ``[n, B, T]`` -> ``[B, T, D]``: the sum of the chosen rows of layers ``st ..``."""
        n, B, T = codes.shape
        flat = self.embed[st : st + n].reshape(n * self.codebook_size, self.dim)
        offsets = torch.arange(n, device=codes.device).reshape(n, 1, 1) * self.codebook_size
        rows = flat.index_select(0, (codes.long() + offsets).reshape(-1))
        return rows.reshape(n, B, T, self.dim).sum(dim=0)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for i in range(self.num_quantizers):
            e = self.embed[i]
            destination[f"{prefix}layers.{i}._codebook.embed"] = e if keep_vars else e.detach()

    def _load_from_state_dict(
        self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys, error_msgs
    ):
        stem = f"{prefix}layers."
        with torch.no_grad():
            for i in range(self.num_quantizers):
                key = f"{stem}{i}._codebook.embed"
                if key not in state_dict:
                    missing_keys.append(key)
                elif tuple(state_dict[key].shape) != tuple(self.embed.shape[1:]):
                    error_msgs.append(
                        f"size mismatch for {key}: {tuple(state_dict[key].shape)} "
                        f"vs {tuple(self.embed.shape[1:])}"
                    )
                else:
                    self.embed[i].copy_(state_dict[key])
        for key in state_dict:
            if not key.startswith(prefix):
                continue
            parts = key[len(stem):].split(".") if key.startswith(stem) else []
            known = (
                len(parts) == 3
                and parts[0].isdigit()
                and int(parts[0]) < self.num_quantizers
                and parts[1] == "_codebook"
                and parts[2] in ("embed",) + _EMA_KEYS
            )
            if not known:
                unexpected_keys.append(key)
