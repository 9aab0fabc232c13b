"""The HiFi-Codec family: the program's VQVAE, its reference, and their shared layout.

A configuration file of this family holds the recipe's JSON fields that
shape the model (``upsample_rates``, ``upsample_kernel_sizes``,
``upsample_initial_channel``, ``resblock_kernel_sizes``,
``resblock_dilation_sizes``, ``encoder_base_channels``, ``n_code_groups``,
``n_codes``, ``sampling_rate``) beside its ``preset``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import inputs
from portbench.bounds import tower_ms
from portbench.reference import hificodec as ref

KEYS = ("upsample_rates", "upsample_kernel_sizes", "upsample_initial_channel", "resblock_kernel_sizes",
        "resblock_dilation_sizes", "encoder_base_channels", "n_code_groups", "n_codes", "sampling_rate")
FUSED_MAX_CHANNELS = 64  # stages this narrow run the hand-written towers (K3 / K4)
BATCH_AXIS, TIME_AXIS = 0, 1  # of the tokens [B, T, layers * G]
specs = ref.param_specs
Reference = ref.HiFiCodecReference


def sample_rate(cfg: dict) -> int:
    return cfg["sampling_rate"]


def codebook_size(cfg: dict) -> int:
    return cfg["n_codes"]


def post_bias(cfg: dict) -> str:
    """The bias of the generator's ``conv_post``, in front of the tanh."""
    return "generator.conv_post.bias"


def _tuples(v):
    return tuple(_tuples(e) for e in v) if isinstance(v, (list, tuple)) else v


def build_program(cfg: dict, sd: Dict[str, torch.Tensor], dtype: torch.dtype, device, **kw):
    """The program's VQVAE through its public loader, with the benchmark's weights
    (``load_reference`` of the three ``g_*`` parts)."""
    from academicodec_tpu_torch.api import load_codec

    model = load_codec(cfg["preset"], device=device, dtype=dtype, **{k: _tuples(cfg[k]) for k in KEYS}, **kw)
    parts = {p: {k[len(p) + 1:]: v for k, v in sd.items() if k.startswith(p + ".")}
             for p in ("encoder", "generator", "quantizer")}
    model.load_reference(parts)
    return model


def set_codebooks(cfg: dict, sd: Dict[str, torch.Tensor], frames: torch.Tensor, seed: int) -> None:
    G = cfg["n_code_groups"]
    books = inputs.spread_codebooks(frames, 2, G, cfg["n_codes"], seed)
    for i, prefix in enumerate(("quantizer_modules", "quantizer_modules2")):
        for g in range(G):
            sd[f"quantizer.{prefix}.{g}.embedding.weight"] = books[i, g]


def frames_for(cfg: dict, n: int) -> int:
    for u, k in reversed(list(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]))):
        n = (n + 2 * ((k - u) // 2) - k) // u + 1
    return n


def row_slice(codes: torch.Tensor, b0: int, b1: int) -> torch.Tensor:
    """Rows ``b0:b1`` of the program's tokens ``[B, T, layers * G]``."""
    return codes[b0:b1]


def join_rows(per_row: List[torch.Tensor], frames: int) -> torch.Tensor:
    """Tokens ``[1, f, layers * G]`` of single clips -> ``[B, frames, layers * G]``, zero past each clip."""
    out = per_row[0].new_zeros((len(per_row), frames, per_row[0].shape[2]))
    for b, c in enumerate(per_row):
        out[b, : c.shape[1]] = c[0]
    return out


def codes_by_layer(codes: torch.Tensor, rows: List[int], frames: List[int]) -> List[torch.Tensor]:
    """The program's tokens ``[B, T, layers * G]`` -> per layer ``[N, G]`` over the
    valid frames of ``rows``, row-major."""
    flat = torch.cat([codes[b, :f] for b, f in zip(rows, frames)])
    G = flat.shape[1] // 2
    return [flat[:, i * G:(i + 1) * G] for i in range(2)]


def kernel_calls(cfg: dict, batch: int, samples: int, dtype: str, decode: bool,
                 valid_samples: List[int] = None) -> Dict[str, list]:
    """The least time in ms of each K3 / K4 call of one call of the program: K4 on
    each encoder stage of at most 64 channels, over the valid frames when the
    clips have lengths; K3 on each such generator stage, the last with
    ``conv_post`` fused."""
    rks, rds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
    rates, kernels = cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
    out = {"k4_gn_tower": [], "k3_tower": []}
    base, T = cfg["encoder_base_channels"], samples
    valid = list(valid_samples) if valid_samples is not None else [samples] * batch
    for i, (u, k) in enumerate(reversed(list(zip(rates, kernels)))):
        T = (T + 2 * ((k - u) // 2) - k) // u + 1
        valid = [(v + 2 * ((k - u) // 2) - k) // u + 1 for v in valid]
        ch = base * 2 ** (i + 1)
        if ch <= FUSED_MAX_CHANNELS:
            out["k4_gn_tower"].append(tower_ms(batch, ch, T, rks[::-1], rds[::-1], dtype, frames=sum(valid)))
    if decode:
        c0, T = cfg["upsample_initial_channel"], T
        for i, u in enumerate(rates):
            T *= u
            ch = c0 // 2 ** (i + 1)
            if ch <= FUSED_MAX_CHANNELS:
                last = i == len(rates) - 1
                out["k3_tower"].append(tower_ms(batch, ch, T, rks, rds, dtype, c_post=1 if last else 0,
                                                kp=7 if last else 0))
    return out
