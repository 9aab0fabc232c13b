"""Carry weights across from the JAX package.

The port's own copies of the mappings in
``academicodec_tpu/utils/torch_export.py``: ``export_soundstream`` takes the
JAX ``{'params', 'codebook'}`` tree (any arrays numpy can read) and returns
the reference-layout ``state_dict`` that the port's ``SoundStream`` loads,
whose ``ResidualVQ`` folds the per-layer codebooks into its stacked buffer;
``export_hificodec`` turns a JAX ``VQVAE`` tree into the reference ``g_*``
dict that ``VQVAE.load_reference`` takes.

Layouts (JAX -> torch): conv ``[K, I, O]`` -> ``[O, I, K]``, conv-transpose
``[K, I, O]`` -> ``[I, O, K]``; LSTM weights are already torch-layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONV_NAMES = {"kernel": "weight", "kernel_v": "weight_v", "kernel_g": "weight_g", "bias": "bias"}
_LSTM_PARAMS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _np32(v) -> np.ndarray:
    a = np.asarray(v)
    # jax bf16 arrives as an extension dtype that np.issubdtype does not call floating
    if a.dtype.name == "bfloat16" or (a.dtype != np.float32 and np.issubdtype(a.dtype, np.floating)):
        a = a.astype(np.float32)
    return a


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a)


def conv_state_from_jax(node: Mapping[str, Any], transposed: bool) -> Dict[str, torch.Tensor]:
    """One JAX conv's params -> ``{'weight_v', 'weight_g', 'bias'}`` (or ``'weight'``)."""
    perm = (1, 2, 0) if transposed else (2, 1, 0)
    out = {}
    for ours, value in node.items():
        if ours not in _CONV_NAMES:
            raise KeyError(f"unconvertible conv param {ours!r}")
        a = _np32(value)
        out[_CONV_NAMES[ours]] = _t(a if ours == "bias" else np.transpose(a, perm))
    return out


def _is_lstm_layer(name: str) -> bool:
    return name.startswith("l") and name[1:].isdigit()


def slstm_state_from_jax(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``SLSTM`` params ``{'l0': ..., 'l1': ...}`` -> ``{'lstm.weight_ih_l0', ...}``."""
    return {
        f"lstm.{name}_l{layer[1:]}": _t(_np32(params[name]))
        for layer, params in node.items()
        for name in _LSTM_PARAMS
    }


def seanet_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``SEANetEncoder``/``SEANetDecoder`` param tree -> the port tower's
    ``state_dict`` (keys ``model.N...``)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, d):
        sd.update({f"{prefix}.{k}": v for k, v in d.items()})

    for mod_name, mod in params.items():
        if not mod_name.startswith("model_"):
            raise KeyError(f"unconvertible module {mod_name!r}")
        prefix = f"model.{mod_name[len('model_'):]}"
        for sub, node in mod.items():
            if sub == "conv":
                put(f"{prefix}.conv.conv", conv_state_from_jax(node, False))
            elif sub == "convtr":
                put(f"{prefix}.convtr.convtr", conv_state_from_jax(node, True))
            elif sub == "shortcut":
                put(f"{prefix}.shortcut.conv.conv", conv_state_from_jax(node["conv"], False))
            elif sub.startswith("block_"):
                put(f"{prefix}.block.{sub[len('block_'):]}.conv.conv",
                    conv_state_from_jax(node["conv"], False))
            elif _is_lstm_layer(sub):
                put(prefix, slstm_state_from_jax({sub: node}))
            else:
                raise KeyError(f"unconvertible module {mod_name}/{sub}")
    return sd


def soundstream_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SoundStream ``{'params', 'codebook'}`` -> the reference-layout
    ``state_dict`` (the same keys and values as ``export_soundstream``)."""
    unknown = set(variables["params"]) - {"encoder", "decoder"}
    if unknown:
        raise KeyError(f"unconvertible SoundStream param trees {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    vq = variables["codebook"]["quantizer"]["vq"]
    embed, embed_avg, cluster_size = (_np32(vq[k]) for k in ("embed", "embed_avg", "cluster_size"))
    inited = np.asarray(vq["inited"]).reshape(-1)
    for i in range(embed.shape[0]):
        base = f"quantizer.vq.layers.{i}._codebook."
        sd[base + "embed"] = _t(embed[i])
        sd[base + "embed_avg"] = _t(embed_avg[i])
        sd[base + "cluster_size"] = _t(cluster_size[i])
        # the reference registers inited as a [1] f32 tensor
        sd[base + "inited"] = _t(np.asarray([float(inited[i])], np.float32))
    for tower in ("encoder", "decoder"):
        tower_sd = seanet_state_from_jax(variables["params"][tower])
        sd.update({f"{tower}.{k}": v for k, v in tower_sd.items()})
    return sd


def hifigan_state_from_jax(params: Mapping[str, Any], transposed_ups: bool) -> Dict[str, torch.Tensor]:
    """A JAX ``HiFiGANEncoder``/``HiFiGANGenerator`` param tree -> the
    reference tower's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, d):
        sd.update({f"{prefix}.{k}": v for k, v in d.items()})

    for name, node in params.items():
        if name in ("conv_pre", "conv_post"):
            put(name, conv_state_from_jax(node, False))
        elif name.startswith("ups_"):
            put(f"ups.{name[len('ups_'):]}", conv_state_from_jax(node, transposed_ups))
        elif name.startswith("resblocks_"):
            i = name[len("resblocks_"):]
            for conv_name, conv in node.items():
                # convs1_2 -> convs1.2 (ResBlock1), convs_0 -> convs.0 (ResBlock2)
                stem, j = conv_name.rsplit("_", 1)
                put(f"resblocks.{i}.{stem}.{j}", conv_state_from_jax(conv, False))
        elif name.startswith("normalize_"):
            i = name[len("normalize_"):]
            sd[f"normalize.{i}.weight"] = _t(_np32(node["scale"]))
            sd[f"normalize.{i}.bias"] = _t(_np32(node["bias"]))
        else:
            raise KeyError(f"unconvertible module {name!r}")
    return sd


def hificodec_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX VQVAE ``{'params': ...}`` -> the reference ``g_*`` dict
    ``{'generator', 'encoder', 'quantizer'}`` (the same keys and values as
    ``export_hificodec``)."""
    p = variables["params"]
    codebooks = _np32(p["quantizer"]["codebooks"])  # [2, G, n_codes, D / G]
    q: Dict[str, torch.Tensor] = {}
    for g in range(codebooks.shape[1]):
        q[f"quantizer_modules.{g}.embedding.weight"] = _t(codebooks[0, g])
        q[f"quantizer_modules2.{g}.embedding.weight"] = _t(codebooks[1, g])
    return {
        "generator": hifigan_state_from_jax(p["generator"], transposed_ups=True),
        "encoder": hifigan_state_from_jax(p["encoder"], transposed_ups=False),
        "quantizer": q,
    }
