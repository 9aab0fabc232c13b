"""Token language model over RVQ/GRVQ code streams (the Encodec-paper LM),
and its checkpoints.

The ``n_q`` streams' embeddings are summed (BOS is row ``bins`` of each
stream's table), run through the streaming transformer, and one softmax head
per stream predicts the next frame's token of that stream. LM entropy
coding (``codec/lm_compress.py``) runs it one frame at a time with carried
rolling states.

A checkpoint is a directory holding ``lm_config.json``, with the keys of the
JAX package's (the constructor's, plus ``family``, the codec whose tokens it
models, and ``trained_frames``, the stream length it was trained on), and
one or more ``lm_<step>.pt`` torch state dicts. JAX's orbax checkpoints are
carried across with ``utils/convert.lm_state_from_jax`` and :func:`save_lm`.

Behavioral parity target: academicodec_tpu/models/lm.py:27-92 and
academicodec_tpu/cli/train_lm.py:83-102, 196-240 (``lm_config_dict``,
``load_lm``).
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import List, Optional, Union

import torch
import torch.nn as nn

from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.nn.transformer import MultiheadAttention, Offset, StreamingTransformerEncoder

CONFIG_KEYS = ("n_q", "bins", "dim", "num_heads", "num_layers", "past_context")
META_KEYS = ("trained_frames", "family")


class RVQTokenLM(nn.Module):
    def __init__(self, n_q: int, bins: int = 1024, dim: int = 128, num_heads: int = 8, num_layers: int = 4,
                 hidden_scale: float = 4.0, past_context: int = 1000, *,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        """Random weights drawn from ``seed`` on the CPU (the JAX package's init
        distributions), then moved to ``device``; f32."""
        super().__init__()
        device = resolve_device(device)
        self.n_q, self.bins, self.dim = n_q, bins, dim
        self.num_heads, self.num_layers, self.past_context = num_heads, num_layers, past_context
        self.embeddings = nn.Parameter(torch.empty(n_q, bins + 1, dim))
        self.transformer = StreamingTransformerEncoder(dim, hidden_scale, num_heads, num_layers,
                                                       past_context=past_context)
        self.heads = nn.ModuleList(nn.Linear(dim, bins) for _ in range(n_q))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Embeddings N(0, 0.02^2); attention in-projection and feed-forward
        weights Xavier-uniform, the attention's out-projection uniform
        +-1/sqrt(dim); heads N(0, 1/dim); biases 0; norms 1 and 0."""

        def uniform_(p, bound):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

        def xavier_(p):
            uniform_(p, math.sqrt(6.0 / (p.shape[0] + p.shape[1])))

        self.embeddings.copy_(torch.empty(self.embeddings.shape).normal_(0.0, 0.02, generator=generator))
        for m in self.modules():
            if isinstance(m, MultiheadAttention):
                xavier_(m.in_proj_weight)
                m.in_proj_bias.zero_()
                uniform_(m.out_proj.weight, 1.0 / math.sqrt(m.out_proj.in_features))
                m.out_proj.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for layer in self.transformer.layers:
            for lin in (layer.linear1, layer.linear2):
                xavier_(lin.weight)
                lin.bias.zero_()
        for head in self.heads:
            head.weight.copy_(torch.empty(head.weight.shape).normal_(0.0, self.dim ** -0.5, generator=generator))
            head.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    def config(self) -> dict:
        return {k: getattr(self, k) for k in CONFIG_KEYS}

    def init_states(self, batch: int) -> List[torch.Tensor]:
        """The rolling transformer states of a new stream (one shape for every step)."""
        return self.transformer.init_states(batch, self.device, self.embeddings.dtype)

    def forward(self, prev_codes: torch.Tensor, states: Optional[List[torch.Tensor]] = None, offset: Offset = 0,
                fixed_state: bool = False):
        """``prev_codes [B, T, n_q]`` (``bins`` is BOS) -> ``(logits [B, T, n_q,
        bins], next states, next offset)``."""
        emb = 0.0
        for q in range(self.n_q):
            emb = emb + self.embeddings[q][prev_codes[..., q]]
        y, states, offset = self.transformer(emb, states=states, offset=offset, fixed_state=fixed_state)
        return torch.stack([head(y) for head in self.heads], dim=2), states, offset

    def probabilities(self, prev_codes, states=None, offset: Offset = 0, fixed_state: bool = False):
        logits, states, offset = self(prev_codes, states, offset, fixed_state)
        return torch.softmax(logits, dim=-1), states, offset


def save_lm(lm: RVQTokenLM, directory: str, step: int = 0, *, family: Optional[str] = None,
            trained_frames: Optional[int] = None) -> str:
    """Write ``lm_config.json`` and ``lm_<step>.pt`` into ``directory``; returns the latter's path."""
    os.makedirs(directory, exist_ok=True)
    cfg = lm.config()
    if family is not None:
        cfg["family"] = family
    if trained_frames is not None:
        cfg["trained_frames"] = int(trained_frames)
    with open(os.path.join(directory, "lm_config.json"), "w") as fh:
        json.dump(cfg, fh)
    path = os.path.join(directory, f"lm_{step:08d}.pt")
    torch.save({k: v.detach().cpu() for k, v in lm.state_dict().items()}, path)
    return path


def load_lm(path: str, expect_family: Optional[str] = None, expect_nq: Optional[int] = None,
            expect_bins: Optional[int] = None, device: Union[str, torch.device] = "cuda"):
    """``(lm, meta)`` from a checkpoint directory (its latest ``lm_<step>.pt``)
    or one ``lm_<step>.pt`` in it; ``meta`` holds the config's ``family`` and
    ``trained_frames`` where present. ``expect_*`` check the LM against the
    codec whose tokens it is to code and raise ``ValueError`` on a mismatch;
    a checkpoint without a family passes the family check."""
    if os.path.isfile(path):
        directory, ckpt = os.path.dirname(path), path
    else:
        found = sorted(glob.glob(os.path.join(path, "lm_" + "?" * 8 + ".pt")))
        if not found:
            raise FileNotFoundError(f"no lm_<step>.pt checkpoint under {path}")
        directory, ckpt = path, found[-1]
    with open(os.path.join(directory, "lm_config.json")) as fh:
        cfg = json.load(fh)
    meta = {k: cfg.pop(k) for k in META_KEYS if k in cfg}
    family = meta.get("family")
    if expect_family is not None and family not in (None, expect_family):
        raise ValueError(f"LM checkpoint at {path} models '{family}' token streams, not '{expect_family}' "
                         f"(train it with --family {expect_family})")
    if (expect_nq is not None and cfg["n_q"] != expect_nq) or (expect_bins is not None and cfg["bins"] != expect_bins):
        raise ValueError(f"LM shape mismatch: LM (n_q={cfg['n_q']}, bins={cfg['bins']}) vs codec "
                         f"(n_q={expect_nq}, bins={expect_bins})")
    lm = RVQTokenLM(**cfg, device=device)
    lm.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    return lm, meta
