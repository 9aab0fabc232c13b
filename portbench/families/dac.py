"""The DAC family: the program's Descript Audio Codec, its reference, and their shared layout.

A configuration file of this family holds the numbers of HF
``descript/dac_44khz`` ``config.json`` (``DacConfig``) under its keys,
beside its ``preset``. The program's codes are SoundStream's layout ``[n_q,
B, frames]``. The check follows DAC's own search (``entries/codec_fvq.py``):
every layer's projection of the residual that the program's codes leave,
against the layer's normalized codebook scaled to the projections' size.

The weights are torch's uniform init; the Snake alphas, drawn ``U(-1, 1)``
as exponents, become ``5 ** u`` (:func:`set_alphas`: log-uniform on [0.2,
5]); each layer's codebook is spread over that layer's normalized
projections of the reference's residuals (:func:`set_codebooks`).

Kept here too: the Snake epilogues of a call, launch by launch, from the
configuration's structure (:func:`snake_launches`), their least time
(:func:`snake_ms`), read by ``metrics/snake_roofline.py``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.bounds import PEAK_FLOPS, least_ms
from portbench.families.soundstream import BATCH_AXIS, TIME_AXIS, codes_by_layer, join_rows, row_slice  # noqa: F401
from portbench.reference import dac as ref

specs = ref.param_specs
Reference = ref.DacReference
frames_for = ref.frames_for
ALPHA_RANGE = 5.0  # alphas log-uniform on [1 / 5, 5]
SNAKE_FLOPS = 8  # f32 operations an element: the adds, the product, the reduction, sin^2, the FMA

# the preset's keyword <- the configuration's key
KEYS = {"encoder_dim": "encoder_hidden_size", "encoder_rates": "downsampling_ratios", "latent_dim": "hidden_size",
        "decoder_dim": "decoder_hidden_size", "decoder_rates": "upsampling_ratios", "n_codebooks": "n_codebooks",
        "codebook_size": "codebook_size", "codebook_dim": "codebook_dim", "sample_rate": "sampling_rate"}


def sample_rate(cfg: dict) -> int:
    return cfg["sampling_rate"]


def codebook_size(cfg: dict) -> int:
    return cfg["codebook_size"]


def post_bias(cfg: dict) -> str:
    """The bias of the decoder's ``conv_out``, in front of the tanh."""
    return f"decoder.model.{len(cfg['upsampling_ratios']) + 2}.bias"


def build_program(cfg: dict, sd: Dict[str, torch.Tensor], dtype: torch.dtype, device):
    """The program's DAC through its public loader, with the benchmark's weights."""
    from academicodec_tpu_torch.api import load_codec

    kw = {k: tuple(cfg[c]) if isinstance(cfg[c], list) else cfg[c] for k, c in KEYS.items()}
    model = load_codec(cfg["preset"], device=device, dtype=dtype, **kw)
    model.load_state_dict(sd)
    return model


def set_alphas(sd: Dict[str, torch.Tensor]) -> None:
    """Each Snake alpha, drawn ``u ~ U(-1, 1)``, as ``5 ** u``."""
    for name in sd:
        if name.endswith(".alpha"):
            sd[name] = ALPHA_RANGE ** sd[name]


def set_codebooks(cfg: dict, sd: Dict[str, torch.Tensor], frames: torch.Tensor, seed: int) -> None:
    """Layer by layer, the codebook spread over that layer's normalized projections of
    the residual of the latent ``frames`` that the layers before it leave."""
    r, rf = frames, ref.DacReference(cfg, sd)
    for i in range(cfg["n_codebooks"]):
        base = f"quantizer.quantizers.{i}"
        p = F.normalize(rf.proj(f"{base}.in_proj", r))
        book = inputs.spread_codebooks(p.contiguous(), 1, 1, cfg["codebook_size"], seed + i)[0, 0]
        sd[f"{base}.codebook.weight"] = book
        r = r - rf.proj(f"{base}.out_proj", book[ref.nearest(p, book)])


def kernel_calls(cfg: dict, batch: int, samples: int, dtype: str, decode: bool,
                 valid_samples: List[int] = None) -> Dict[str, list]:
    """None of K1-K4 runs in a DAC call."""
    return {}


class Launch(NamedTuple):
    channels: int
    frames: int
    residual: bool  # reads a residual
    keeps_sum: bool  # writes the sum for a later residual add


def _units(c: int, t: int, first_residual: bool) -> List[Launch]:
    """Three residual units' Snakes: the first unit's input sum without a residual
    (a conv's output and its bias) where ``first_residual`` is False."""
    out = []
    for k in range(3):
        out += [Launch(c, t, first_residual or k > 0, True), Launch(c, t, False, False)]
    return out


def snake_launches(cfg: dict, samples: int, decode: bool) -> List[Launch]:
    """The epilogues of one clip's encode (and decode), in order, from the configuration."""
    t, c = frames_for(cfg, samples) * ref.hop(cfg), cfg["encoder_hidden_size"]
    out: List[Launch] = []
    for s in cfg["downsampling_ratios"]:
        out += _units(c, t, False) + [Launch(c, t, True, False)]  # the block's Snake ends the third unit
        t, c = t // s, 2 * c
    out.append(Launch(c, t, False, False))
    if not decode:
        return out
    t, c = frames_for(cfg, samples), cfg["decoder_hidden_size"]
    for i, s in enumerate(cfg["upsampling_ratios"]):
        out.append(Launch(c, t, i > 0, False))  # after the first block, it ends the last unit
        t, c = t * s, c // 2
        out += _units(c, t, False)
    out.append(Launch(c, t, True, False))
    return out


def snake_work(cfg: dict, batch: int, samples: int, decode: bool, item: int):
    """``(operations, bytes)`` of one call's epilogues over ``batch`` clips of
    ``samples``: ``SNAKE_FLOPS`` an element; each launch's input, residual, ``y``
    and sum moved once, ``item`` bytes an element (alphas and biases left out)."""
    flops = nbytes = 0.0
    for launch in snake_launches(cfg, samples, decode):
        n = batch * launch.channels * launch.frames
        flops += SNAKE_FLOPS * n
        nbytes += item * n * (2 + launch.residual + launch.keeps_sum)
    return flops, nbytes


def snake_ms(cfg: dict, batch: int, samples: int, dtype: str, decode: bool) -> float:
    """The least time in ms of one call's epilogues: f32 operations at the f32 peak
    or bytes at the HBM rate."""
    flops, nbytes = snake_work(cfg, batch, samples, decode, 2 if dtype == "bfloat16" else 4)
    return least_ms(flops, nbytes, PEAK_FLOPS["float32"])
