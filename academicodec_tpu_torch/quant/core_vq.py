"""Residual vector quantization with EMA codebooks: serving and training.

All ``n_q`` codebooks live in one stacked ``embed [n_q, K, D]`` buffer,
beside the EMA state the trainer keeps: ``embed_avg [n_q, K, D]``,
``cluster_size [n_q, K]`` and ``inited [n_q]`` (bool). ``encode`` is greedy
residual quantization through ``ops/cuda/rvq`` (K1 for CUDA tensors, its
plain version for CPU tensors); ``decode`` is one gather from the flattened
codebook and a sum over layers.

``forward(x, n_q, training, draws)`` is the training and evaluation
forward of the JAX package (academicodec_tpu/quant/core_vq.py:144-290):

* k-means init (50 Lloyd steps) of each layer on its first active batch;
* the residual search: once every active layer is inited, one K1 call over
  ``embed[:n_q]`` gives all the codes; in a step that inits a layer the
  search runs layer by layer, one K1 call each, because a layer's k-means
  sees the residual that the layers before it left. Every k-means
  assignment is a K1 call with one layer (``rvq_encode(samples, means[None])``);
* global one-hot EMA statistics, Laplace smoothing, and dead-code expiry
  applied *after* the EMA update, so that the replacement survives it
  (COMPONENTS.md deviations 1-2);
* the straight-through quantize, the commitment loss, and layers past
  ``n_q`` masked out (not computed; their codebooks are left as they are).

Under data parallelism (``group``, a ``torch.distributed`` process group;
``parallel/mesh.py``) each rank quantizes its own rows of the microbatch,
and the codebooks follow the global batch, as GSPMD makes them follow it in
JAX (academicodec_tpu/quant/core_vq.py:203-208, "all replicas apply the same
update"): the EMA sums ``onehot_sum`` and ``embed_sum`` and the dead-code
samples are summed over the ranks before the update, and k-means runs on
the rank-major gather of every rank's residuals. K-means runs on rank 0 and
its result is broadcast: ``index_add_`` on the card sums with atomics, so
two ranks running it on the same rows could part in the last bit and their
codebooks drift. Every rank so holds bitwise the same codebooks after every
step. Without a group the same code runs on the local batch and issues no
collective.

The gradient path (STE, commit, EMA sums) is plain torch on the chosen rows.
It carries the residual as JAX does, ``r - (r + sg(q - r))``, which can
differ from K1's ``r - q`` by an ulp, so the codes of JAX and the port can
part only at exact near-ties (the tests assert them equal).

``draws`` holds the forward's random rows: ``[n_q_max, K]`` indices into the
``B * T`` latent frames, one row of draws per layer, which seed that
layer's k-means and replace its dead codes (JAX draws both from one key per
layer). :func:`sample_rows` draws them from a CPU ``torch.Generator``, so the
card and the CPU see the same draws; a parity test passes JAX's. Under data
parallelism the rows index the global microbatch's frames, rank-major.

``inited`` has a host mirror, so a training step reads no device flag;
loading a state dict refreshes it.

State-dict keys follow the reference, per layer
``layers.{i}._codebook.{embed, embed_avg, cluster_size, inited}`` (``inited``
a ``[1]`` f32 as the reference registers it); loading folds them into the
stacked buffers.

Behavioral parity target: academicodec_tpu/quant/core_vq.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from academicodec_tpu_torch.ops.cuda.rvq import l2_distance_argmin, rvq_encode
from academicodec_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum_, rank, replicate

__all__ = ["ResidualVQ", "kmeans", "l2_distance_argmin", "sample_rows"]

_LAYER_KEYS = ("embed", "embed_avg", "cluster_size", "inited")

# the reference's settings, which every caller takes (academicodec_tpu/quant/core_vq.py:114-119)
DECAY = 0.99
EPSILON = 1e-5
KMEANS_ITERS = 50
THRESHOLD_EMA_DEAD_CODE = 2.0
COMMITMENT_WEIGHT = 1.0


def sample_rows(generator: torch.Generator, n: int, num: int) -> torch.Tensor:
    """``num`` row indices into ``n`` samples, without replacement when ``n >= num``
    (JAX ``sample_vectors``: a permutation's head, else uniform draws) -> ``[num]`` int64."""
    if n >= num:
        return torch.randperm(n, generator=generator)[:num]
    return torch.randint(0, n, (num,), generator=generator)


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(idx, minlength=n)`` for ``idx < n``, without the host sync that
    ``torch.bincount`` makes on the card to size its output."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(0, idx, torch.ones_like(idx))


def kmeans(samples: torch.Tensor, rows: torch.Tensor, num_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means of ``samples [N, D]`` seeded at ``samples[rows]``; an empty
    cluster keeps its mean. Each assignment is one K1 call (the plain version
    on the CPU). Returns ``(means [K, D], bins [K])`` (JAX core_vq.py:75-97)."""
    means = samples.index_select(0, rows)
    k = means.shape[0]

    def assign(means):
        buckets = rvq_encode(samples, means[None])[0].long()
        return buckets, _counts(buckets, k).to(samples.dtype)

    for _ in range(num_iters):
        buckets, bins = assign(means)
        new_means = torch.zeros_like(means).index_add_(0, buckets, samples) / bins.clamp(min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    return means, assign(means)[1]


class ResidualVQ(nn.Module):
    """Stack of EMA codebooks applied to the residual; layout ``[B, T, D]``."""

    def __init__(self, num_quantizers: int, dim: int, codebook_size: int = 1024):
        super().__init__()
        self.num_quantizers, self.dim, self.codebook_size = num_quantizers, dim, codebook_size
        self.register_buffer("embed", torch.zeros(num_quantizers, codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(num_quantizers, codebook_size, dim))
        self.register_buffer("cluster_size", torch.zeros(num_quantizers, codebook_size))
        self.register_buffer("inited", torch.ones(num_quantizers, dtype=torch.bool))
        self._inited_host: Optional[List[bool]] = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1) codebooks: random but non-degenerate, so the search does real work."""
        with torch.no_grad():
            self.embed.copy_(torch.randn(self.embed.shape, generator=generator))
            self.embed_avg.copy_(self.embed)
            self.cluster_size.zero_()
            self.set_inited(True)

    def init_training_state(self) -> None:
        """The JAX trainer's initial codebook state under k-means init: zeros,
        every layer un-inited."""
        with torch.no_grad():
            self.embed.zero_()
            self.embed_avg.zero_()
            self.cluster_size.zero_()
            self.set_inited(False)

    def set_inited(self, value: bool) -> None:
        """Every layer's ``inited`` flag, and its host mirror."""
        self.inited.fill_(value)
        self._inited_host = [value] * self.num_quantizers

    def inited_layers(self) -> List[bool]:
        if self._inited_host is None:
            self._inited_host = [bool(v) for v in self.inited.tolist()]
        return self._inited_host

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    def forward(
        self,
        x: torch.Tensor,
        n_q: Optional[int] = None,
        training: bool = False,
        draws: Optional[torch.Tensor] = None,
        group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Quantize ``x [B, T, D]`` with the first ``n_q`` layers -> ``(quantized
        [B, T, D] in x's dtype, codes [n_q, B, T] int32, commit losses [n_q] f32)``.
        ``training`` updates the EMA state and needs ``draws`` (module docstring);
        the codebook dtype rules the arithmetic (bf16 activations are upcast).
        ``group``: the data-parallel process group; ``x`` is then this rank's rows."""
        n_q = self.num_quantizers if n_q is None else int(n_q)
        if not 1 <= n_q <= self.num_quantizers:
            raise ValueError(f"n_q {n_q} outside 1..{self.num_quantizers}")
        B, T, D = x.shape
        out_dtype = x.dtype
        flat = x.reshape(B * T, D).to(self.embed.dtype)
        inited = self.inited_layers()
        init_step = training and not all(inited[:n_q])
        if training and draws is None:
            raise ValueError("a training forward needs its row draws (quant.core_vq.sample_rows)")
        rows = None if draws is None else draws.to(device=x.device, dtype=torch.long)
        codes_all = None if init_step else rvq_encode(flat.detach(), self.embed[:n_q])

        residual, quantized = flat, None
        codes, residuals, losses = [], [], []
        for i in range(n_q):
            r = residual.detach()
            if codes_all is None:
                if not inited[i]:
                    self._kmeans_init_layer(i, r, rows[i], group)
                idx = rvq_encode(r, self.embed[i : i + 1])[0]
            else:
                idx = codes_all[i]
            q = self.embed[i].index_select(0, idx.long())
            if training:  # straight-through quantize and commitment, carried as JAX does
                q_st = residual + (q - residual).detach()
                losses.append((q - residual).square().mean() * COMMITMENT_WEIGHT)
            else:
                q_st = q
                losses.append(q.new_zeros(()))
            codes.append(idx)
            residuals.append(r)
            quantized = q_st if quantized is None else quantized + q_st
            residual = residual - q_st
        if training:
            self._ema_update(torch.stack(residuals), torch.stack(codes).long(), rows, group)
        return (
            quantized.reshape(B, T, D).to(out_dtype),
            torch.stack(codes).to(torch.int32).reshape(n_q, B, T),
            torch.stack(losses).float(),
        )

    @torch.no_grad()
    def _kmeans_init_layer(self, i: int, samples: torch.Tensor, rows: torch.Tensor, group=None) -> None:
        """K-means of layer ``i`` on the global batch's residuals, on rank 0, broadcast."""
        samples = all_gather_rows(samples, group)
        if rank(group) == 0:
            means, bins = kmeans(samples, rows, KMEANS_ITERS)
        else:
            means, bins = samples.new_empty(self.codebook_size, self.dim), samples.new_empty(self.codebook_size)
        replicate([means, bins], group)
        self.embed[i] = means
        self.embed_avg[i] = means
        self.cluster_size[i] = bins
        self.inited[i] = True
        self.inited_layers()[i] = True

    @torch.no_grad()
    def _ema_update(self, residuals: torch.Tensor, codes: torch.Tensor, rows: torch.Tensor, group=None) -> None:
        """The EMA step of the active layers at once: ``residuals [n_q, N, D]`` are
        the inputs each layer quantized, ``codes [n_q, N]`` its choices (this
        rank's rows under ``group``)."""
        n_q, N, D = residuals.shape
        K = self.codebook_size
        offsets = (codes + torch.arange(n_q, device=codes.device)[:, None] * K).reshape(-1)
        onehot_sum = _counts(offsets, n_q * K).to(residuals.dtype).reshape(n_q, K)
        embed_sum = residuals.new_zeros(n_q * K, D).index_add_(0, offsets, residuals.reshape(-1, D))
        # the dead-code samples: the rows draw from the global batch; this rank
        # fills the ones it holds and the sum over the ranks fills the rest
        layer = torch.arange(n_q, device=residuals.device)[:, None]
        local = rows[:n_q] - rank(group) * N
        held = (local >= 0) & (local < N)
        samples = torch.where(held[..., None], residuals[layer, local.clamp(0, N - 1)], 0.0)  # [n_q, K, D]
        all_reduce_sum_([onehot_sum, embed_sum, samples], group)  # one all-reduce
        cluster_size, embed_avg = self.cluster_size[:n_q], self.embed_avg[:n_q]
        expired = cluster_size < THRESHOLD_EMA_DEAD_CODE  # decided on the statistics before the step
        new_cluster = cluster_size * DECAY + onehot_sum * (1 - DECAY)
        new_embed_avg = embed_avg * DECAY + embed_sum.reshape(n_q, K, D) * (1 - DECAY)
        csum = new_cluster.sum(dim=-1, keepdim=True)
        smoothed = (new_cluster + EPSILON) / (csum + K * EPSILON) * csum
        new_embed = new_embed_avg / smoothed[..., None]
        # dead-code expiry, applied after the EMA step so that it survives
        dead = expired[..., None]
        new_embed = torch.where(dead, samples, new_embed)
        new_embed_avg = torch.where(dead, samples * THRESHOLD_EMA_DEAD_CODE, new_embed_avg)
        new_cluster = torch.where(expired, torch.full_like(new_cluster, THRESHOLD_EMA_DEAD_CODE), new_cluster)
        self.embed[:n_q] = new_embed
        self.embed_avg[:n_q] = new_embed_avg
        self.cluster_size[:n_q] = new_cluster

    # ------------------------------------------------------------------
    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for i in range(self.num_quantizers):
            base = f"{prefix}layers.{i}._codebook."
            values = (self.embed[i], self.embed_avg[i], self.cluster_size[i], self.inited[i : i + 1].float())
            for name, value in zip(_LAYER_KEYS, values):
                destination[base + name] = value if keep_vars else value.detach()

    def _load_from_state_dict(
        self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys, error_msgs
    ):
        stem = f"{prefix}layers."
        shapes = {"embed": self.embed.shape[1:], "embed_avg": self.embed.shape[1:],
                  "cluster_size": self.cluster_size.shape[1:], "inited": (1,)}
        with torch.no_grad():
            for i in range(self.num_quantizers):
                for name in _LAYER_KEYS:
                    key = f"{stem}{i}._codebook.{name}"
                    if key not in state_dict:
                        missing_keys.append(key)
                        continue
                    value = state_dict[key]
                    if tuple(value.shape) != tuple(shapes[name]):
                        error_msgs.append(f"size mismatch for {key}: {tuple(value.shape)} vs {tuple(shapes[name])}")
                    elif name == "inited":
                        self.inited[i] = bool(value.reshape(()) > 0)
                    else:
                        getattr(self, name)[i].copy_(value)
        self._inited_host = None
        for key in state_dict:
            if not key.startswith(prefix):
                continue
            parts = key[len(stem):].split(".") if key.startswith(stem) else []
            known = (
                len(parts) == 3
                and parts[0].isdigit()
                and int(parts[0]) < self.num_quantizers
                and parts[1] == "_codebook"
                and parts[2] in _LAYER_KEYS
            )
            if not known:
                unexpected_keys.append(key)
