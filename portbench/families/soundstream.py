"""The SoundStream / Encodec family: the program's model, its reference, and their shared layout.

A configuration file of this family holds SoundStream's constructor
arguments (``n_filters``, ``dimension``, ``ratios``, ``sample_rate``,
``target_bandwidths``, ``bins``) beside its ``preset``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import inputs
from portbench.bounds import k1_rvq_ms, k2_lstm2_ms
from portbench.reference import soundstream as ref

KEYS = ("n_filters", "dimension", "ratios", "sample_rate", "target_bandwidths", "bins")
BATCH_AXIS, TIME_AXIS = 1, 2  # of the codes [n_q, B, T]
specs = ref.param_specs
Reference = ref.SoundStreamReference


def sample_rate(cfg: dict) -> int:
    return cfg["sample_rate"]


def codebook_size(cfg: dict) -> int:
    return cfg["bins"]


def frames_for(cfg: dict, n: int) -> int:
    return math.ceil(n / math.prod(cfg["ratios"]))


def post_bias(cfg: dict) -> str:
    """The bias of the decoder's last conv, in front of the wav."""
    return f"decoder.model.{3 * len(cfg['ratios']) + 3}.conv.conv.bias"


def build_program(cfg: dict, sd: Dict[str, torch.Tensor], dtype: torch.dtype, device):
    """The program's model through its public loader, with the benchmark's weights."""
    from academicodec_tpu_torch.api import load_codec

    model = load_codec(cfg["preset"], device=device, dtype=dtype, **{k: cfg[k] for k in KEYS})
    model.load_state_dict(sd)
    return model


def set_codebooks(cfg: dict, sd: Dict[str, torch.Tensor], frames: torch.Tensor, seed: int) -> None:
    """Codebooks spread over the reference's latent ``frames`` (one group a layer)."""
    books = inputs.spread_codebooks(frames, ref.n_q(cfg), 1, cfg["bins"], seed)[:, 0]
    for i, book in enumerate(books):
        sd[f"quantizer.vq.layers.{i}._codebook.embed"] = book
        sd[f"quantizer.vq.layers.{i}._codebook.embed_avg"] = book.clone()


def row_slice(codes: torch.Tensor, b0: int, b1: int) -> torch.Tensor:
    """Rows ``b0:b1`` of the program's codes ``[n_q, B, T]``."""
    return codes[:, b0:b1]


def join_rows(per_row: List[torch.Tensor], frames: int) -> torch.Tensor:
    """Codes ``[n_q, 1, f]`` of single clips -> ``[n_q, B, frames]``, zero past each clip."""
    out = per_row[0].new_zeros((per_row[0].shape[0], len(per_row), frames))
    for b, c in enumerate(per_row):
        out[:, b, : c.shape[2]] = c[:, 0]
    return out


def codes_by_layer(codes: torch.Tensor, rows: List[int], frames: List[int]) -> List[torch.Tensor]:
    """The program's codes ``[n_q, B, T]`` -> per layer ``[N, 1]`` over the valid
    frames of ``rows``, row-major."""
    return [torch.cat([codes[layer, b, :f] for b, f in zip(rows, frames)])[:, None]
            for layer in range(codes.shape[0])]


def kernel_calls(cfg: dict, batch: int, samples: int, dtype: str, decode: bool,
                 valid_samples: List[int] = None) -> Dict[str, list]:
    """The least time in ms of each K1 / K2 call of one call of the program: one
    search over every frame, and one recurrence in each SLSTM it runs."""
    frames, n_q = frames_for(cfg, samples), ref.n_q(cfg)
    k2 = k2_lstm2_ms(frames, batch, cfg["n_filters"] * 2 ** len(cfg["ratios"]), dtype)
    return {"k1_rvq": [k1_rvq_ms(batch * frames, cfg["bins"], cfg["dimension"], n_q)],
            "k2_lstm2": [k2, k2] if decode else [k2]}
