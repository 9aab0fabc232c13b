"""The Mimi family: the program's Mimi, its reference, and their shared layout.

A configuration file of this family holds the numbers of HF ``kyutai/mimi``
``config.json`` under its keys, beside its ``preset``. The program's codes
are SoundStream's layout ``[n_q, B, frames]``. The check follows one
residual chain over the reference's :meth:`~portbench.reference.mimi.MimiReference.latents`:
the two parts' projected frames side by side, each part's codebooks
zero-padded into the other's half.

Kept here too: the least time of the two transformers of a call
(:func:`transformer_ms`), read by ``metrics/transformer_roofline.py``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import inputs
from portbench.bounds import PEAK_FLOPS, k1_rvq_ms, least_ms
from portbench.families.soundstream import BATCH_AXIS, TIME_AXIS, codes_by_layer, join_rows, row_slice  # noqa: F401
from portbench.reference import mimi as ref

specs = ref.param_specs
Reference = ref.MimiReference
frames_for = ref.frames_for
TRANSFORMERS = 2  # one after the encoder, one before the decoder

# the preset's keyword <- the configuration's key
KEYS = {"n_filters": "num_filters", "dimension": "hidden_size", "ratios": "upsampling_ratios",
        "sample_rate": "sampling_rate", "num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
        "ffn_dim": "intermediate_size", "context": "sliding_window", "n_q": "num_quantizers",
        "codebook_dim": "codebook_dim", "bins": "codebook_size"}


def sample_rate(cfg: dict) -> int:
    return cfg["sampling_rate"]


def codebook_size(cfg: dict) -> int:
    return cfg["codebook_size"]


def post_bias(cfg: dict) -> str:
    """The bias of the decoder's last conv, in front of the wav."""
    return f"decoder.model.{3 * len(cfg['upsampling_ratios']) + 2}.conv.conv.bias"


def build_program(cfg: dict, sd: Dict[str, torch.Tensor], dtype: torch.dtype, device):
    """The program's Mimi through its public loader, with the benchmark's weights."""
    from academicodec_tpu_torch.api import load_codec

    kw = {k: tuple(cfg[c]) if isinstance(cfg[c], list) else cfg[c] for k, c in KEYS.items()}
    model = load_codec(cfg["preset"], device=device, dtype=dtype, **kw)
    model.load_state_dict(sd)
    return model


def set_codebooks(cfg: dict, sd: Dict[str, torch.Tensor], frames: torch.Tensor, seed: int) -> None:
    """Each part's codebooks spread over its own projected frames (the first
    ``codebook_dim`` columns of ``frames`` the first part's, the rest the rest's)."""
    c, K = cfg["codebook_dim"], cfg["codebook_size"]
    semantic = cfg["num_semantic_quantizers"]
    parts = (("rvq_first", semantic, frames[:, :c], seed), ("rvq_rest", cfg["num_quantizers"] - semantic,
                                                              frames[:, c:], seed + 1))
    for name, layers, part, s in parts:
        books = inputs.spread_codebooks(part.contiguous(), layers, 1, K, s)[:, 0]
        for i, book in enumerate(books):
            sd[f"quantizer.{name}.vq.layers.{i}._codebook.embed"] = book
            sd[f"quantizer.{name}.vq.layers.{i}._codebook.embed_avg"] = book.clone()


def kernel_calls(cfg: dict, batch: int, samples: int, dtype: str, decode: bool,
                 valid_samples: List[int] = None) -> Dict[str, list]:
    """The least time in ms of each K1 call of one call of the program: one search
    for each part of the split RVQ, over every frame."""
    n, K, c = batch * frames_for(cfg, samples), cfg["codebook_size"], cfg["codebook_dim"]
    semantic = cfg["num_semantic_quantizers"]
    return {"k1_rvq": [k1_rvq_ms(n, K, c, semantic), k1_rvq_ms(n, K, c, cfg["num_quantizers"] - semantic)]}


def band_pairs(T: int, context: int) -> int:
    """Query-key pairs of a causal window of ``context`` keys over ``T`` frames."""
    w = min(T, context)
    return w * (w + 1) // 2 + (T - w) * context


def layer_weights(cfg: dict) -> int:
    """Weights of one transformer layer's matmuls: the packed q/k/v, the output
    projection and the feed-forward."""
    D, ffn = cfg["hidden_size"], cfg["intermediate_size"]
    return 4 * D * D + 2 * D * ffn


def transformer_work(cfg: dict, batch: int, samples: int, decode: bool, item: int):
    """``(operations, bytes)`` of the transformers of one call over clips of
    ``samples``: ``2 x tokens x weights`` a layer and ``4 x pairs x D`` (q.k and
    p.v over the window's pairs); the weights read once and each layer's input
    and output moved once, ``item`` bytes an element."""
    T = -(-samples // ref.encoder_hop(cfg))
    D, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    runs = TRANSFORMERS if decode else 1
    pairs = runs * batch * layers * band_pairs(T, cfg["sliding_window"])
    flops = runs * layers * 2.0 * batch * T * layer_weights(cfg) + 4.0 * pairs * D
    nbytes = float(item) * runs * layers * (layer_weights(cfg) + 2 * batch * T * D)
    return flops, nbytes


def transformer_ms(cfg: dict, batch: int, samples: int, dtype: str, decode: bool) -> float:
    """The least time in ms of the transformers of one call: operations at the
    peak of ``dtype`` or bytes at the HBM rate."""
    flops, nbytes = transformer_work(cfg, batch, samples, decode, 2 if dtype == "bfloat16" else 4)
    return least_ms(flops, nbytes, PEAK_FLOPS[dtype])

