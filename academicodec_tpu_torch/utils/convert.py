"""Carry weights across from the JAX package.

The port's own copies of the mappings in
``academicodec_tpu/utils/torch_export.py``: ``export_soundstream`` takes the
JAX ``{'params', 'codebook'}`` tree (any arrays numpy can read) and returns
the reference-layout ``state_dict`` that the port's ``SoundStream`` loads,
whose ``ResidualVQ`` folds the per-layer codebooks into its stacked buffer;
``export_hificodec`` turns a JAX ``VQVAE`` tree into the reference ``g_*``
dict that ``VQVAE.load_reference`` takes.

Beyond the JAX exporter, which has no mapping for them: the post-conv norms
of the SEANet convs (JAX ``norm/scale,bias`` for TimeGroupNorm and
``norm/ln/scale,bias`` for ConvLayerNorm -> the reference ``NormConv1d``'s
``conv.norm.weight,bias``), SLSTMs of any layer count, the int8 scales of
JAX's ``'quant'`` collection (:func:`hificodec_quant_from_jax`), the
token LM (:func:`lm_state_from_jax`), and the trainers' states
(:func:`train_state_from_jax`, :func:`hificodec_train_state_from_jax`,
:func:`lm_train_state_from_jax`): the codebooks' EMA collection, the
discriminators (Conv2d HWIO -> OIHW, weight norm's g/v, spectral norm's
kernel and its ``'spectral'`` ``kernel_u``) and the optax Adam/AdamW states
(``count``, ``mu``, ``nu``, ``learning_rate``) as ``torch.optim`` states.

Layouts (JAX -> torch): conv ``[K, I, O]`` -> ``[O, I, K]``, conv-transpose
``[K, I, O]`` -> ``[I, O, K]``, dense ``[I, O]`` -> ``[O, I]``; LSTM and
attention in-projection weights are already torch-layout.
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


def norm_state_from_jax(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX post-conv norm (``{'scale', 'bias'}``, or ``{'ln': {...}}`` for
    ConvLayerNorm) or LayerNorm -> ``{'weight', 'bias'}``."""
    node = node.get("ln", node)
    return {"weight": _t(_np32(node["scale"])), "bias": _t(_np32(node["bias"]))}


def sconv_state_from_jax(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``Conv1d`` inside an S-conv -> the port's ``NormConv1d`` state:
    ``conv.*`` and, with a post-conv norm, ``norm.weight`` / ``norm.bias``."""
    node = dict(node)
    norm = node.pop("norm", None)
    sd = {f"conv.{k}": v for k, v in conv_state_from_jax(node, False).items()}
    if norm is not None:
        sd.update({f"norm.{k}": v for k, v in norm_state_from_jax(norm).items()})
    return sd


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
                put(f"{prefix}.conv", sconv_state_from_jax(node))
            elif sub == "convtr":
                put(f"{prefix}.convtr.convtr", conv_state_from_jax(node, True))
            elif sub == "shortcut":
                put(f"{prefix}.shortcut.conv", sconv_state_from_jax(node["conv"]))
            elif sub.startswith("block_"):
                put(f"{prefix}.block.{sub[len('block_'):]}.conv", sconv_state_from_jax(node["conv"]))
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
    sd.update(soundstream_params_from_jax(variables["params"]))
    return sd


def soundstream_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The trained part of a JAX SoundStream (its ``'params'``) -> the port's
    parameter names (``encoder.model.0.conv.conv.weight_v`` ...)."""
    sd: Dict[str, torch.Tensor] = {}
    for tower in ("encoder", "decoder"):
        sd.update({f"{tower}.{k}": v for k, v in seanet_state_from_jax(params[tower]).items()})
    return sd


def conv2d_state_from_jax(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One JAX ``Conv2d``'s params (kernel ``[kh, kw, I, O]``, weight norm's
    ``g`` ``[1, 1, 1, O]``) -> the port's ``Conv2d`` (``[O, I, kh, kw]``)."""
    out = {}
    for ours, value in node.items():
        if ours not in _CONV_NAMES:
            raise KeyError(f"unconvertible conv param {ours!r}")
        a = _np32(value)
        out[_CONV_NAMES[ours]] = _t(a if ours == "bias" else np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1))))
    return out


def discriminators_state_from_jax(params: Mapping[str, Any],
                                  spectral: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """A JAX trainer's discriminator params (the Encodec trainer's ``stft_disc``,
    ``mpd``, ``msd``; the HiFi-Codec trainer's ``mpd``, ``msd``, ``mstftd``) -> the
    port's ``Discriminators`` state dict: ``discriminators_0/convs_1`` becomes
    ``discriminators.0.convs.1``, 2D kernels HWIO -> OIHW, 1D kernels ``[K, I, O]``
    -> ``[O, I, K]``. ``spectral``: the ``'spectral'`` collection, whose
    ``kernel_u`` become the spectral-normed convs' ``weight_u``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(prefix, node, leaf):
        if any(k in node for k in ("kernel", "kernel_v", "kernel_u")):
            leaf(prefix, node)
            return
        for name, child in node.items():
            stem, _, idx = name.rpartition("_")
            walk(f"{prefix}.{stem}.{idx}" if idx.isdigit() else f"{prefix}.{name}", child, leaf)

    def conv(prefix, node):
        ndim = np.asarray(node.get("kernel", node.get("kernel_v"))).ndim
        out = conv2d_state_from_jax(node) if ndim == 4 else conv_state_from_jax(node, False)
        sd.update({f"{prefix}.{k}": v for k, v in out.items()})

    def u(prefix, node):
        sd[f"{prefix}.weight_u"] = _t(_np32(node["kernel_u"]))

    for family, node in params.items():
        walk(family, node, conv)
    for family, node in (spectral or {}).items():
        walk(family, node, u)
    return sd


def adamw_state_from_jax(opt_state: Any, to_port, module: torch.nn.Module) -> Dict[str, Any]:
    """An optax ``inject_hyperparams(adamw | adam)`` state (``hyperparams
    ['learning_rate']``, ``inner_state[0]`` with ``count``, ``mu``, ``nu``) -> a
    ``torch.optim.AdamW`` / ``Adam`` state dict over ``module.parameters()``.
    ``to_port`` maps a JAX param tree to the port's names (the function that
    converted the params). Load it with ``optimizer.load_state_dict``, whose
    ``param_groups`` it must match in everything but ``lr`` and the moments."""
    state = _adam_moments(opt_state.inner_state[0], to_port, module)
    return {"state": state, "lr": float(np.asarray(opt_state.hyperparams["learning_rate"]))}


def _adam_moments(adam: Any, to_port, module: torch.nn.Module) -> Dict[int, Dict[str, torch.Tensor]]:
    """An optax ``ScaleByAdamState`` -> the ``state`` of a torch Adam state dict."""
    mu, nu = to_port(adam.mu), to_port(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)))
    names = [name for name, _ in module.named_parameters()]
    missing = set(names) ^ set(mu)
    if missing:
        raise KeyError(f"optimizer moments and parameters differ in {sorted(missing)}")
    return {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]} for i, n in enumerate(names)}


def train_state_from_jax(jstate: Any, state: Any) -> None:
    """Load a JAX ``GANTrainState`` of the Encodec trainer (``step``, ``g_params``,
    ``g_extra['codebook']``, ``d_params``, both optax states) into the port's
    ``GANTrainState`` in place, so that both compute the same step from it. The
    random key is not carried: draws are given to the step (``draws=``)."""
    state.step = int(np.asarray(jstate.step))
    state.generator.load_state_dict(
        soundstream_state_from_jax({"params": jstate.g_params, "codebook": jstate.g_extra["codebook"]}))
    state.discriminators.load_state_dict(discriminators_state_from_jax(jstate.d_params))
    _load_optimizer(state.g_opt, jstate.g_opt_state, soundstream_params_from_jax, state.generator)
    _load_optimizer(state.d_opt, jstate.d_opt_state, discriminators_state_from_jax, state.discriminators)


def hificodec_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX VQVAE's ``'params'`` -> the port ``VQVAE``'s parameter names
    (``encoder.conv_pre.weight_v``, ..., ``quantizer.codebooks``)."""
    sd = {f"encoder.{k}": v for k, v in hifigan_state_from_jax(params["encoder"], transposed_ups=False).items()}
    sd.update({f"generator.{k}": v for k, v in hifigan_state_from_jax(params["generator"], transposed_ups=True).items()})
    sd["quantizer.codebooks"] = _t(_np32(params["quantizer"]["codebooks"]))
    return sd


def _load_optimizer(opt: torch.optim.Optimizer, jopt: Any, to_port, module: torch.nn.Module) -> None:
    converted = adamw_state_from_jax(jopt, to_port, module)
    sd = opt.state_dict()
    for group in sd["param_groups"]:
        group["lr"] = converted["lr"]
    sd["state"] = converted["state"]
    opt.load_state_dict(sd)


def hificodec_train_state_from_jax(jstate: Any, state: Any) -> None:
    """Load a JAX ``GANTrainState`` of the HiFi-Codec trainer (``step``, the VQVAE's
    ``g_params`` with the GRVQ codebooks, ``d_params`` and the ``'spectral'``
    ``u`` of ``d_extra``, both optax Adam states) into the port's
    ``HiFiCodecTrainState`` in place."""
    state.step = int(np.asarray(jstate.step))
    state.generator.load_reference(hificodec_state_from_jax({"params": jstate.g_params}))
    state.discriminators.load_state_dict(
        discriminators_state_from_jax(jstate.d_params, jstate.d_extra.get("spectral")))
    _load_optimizer(state.g_opt, jstate.g_opt_state, hificodec_params_from_jax, state.generator)
    _load_optimizer(state.d_opt, jstate.d_opt_state, discriminators_state_from_jax, state.discriminators)


def hifigan_state_from_jax(params: Mapping[str, Any], transposed_ups: bool) -> Dict[str, torch.Tensor]:
    """A JAX ``HiFiGANEncoder``/``HiFiGANGenerator`` param tree -> the
    reference tower's ``state_dict``. The causal generator's convs carry one
    more level, ``conv`` (``SConv1d``) or ``convtr`` (``SConvTranspose1d``),
    which the port's S-convs hold as ``conv.conv`` / ``convtr.convtr``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, d):
        sd.update({f"{prefix}.{k}": v for k, v in d.items()})

    def put_conv(prefix, node, transposed):
        if "conv" in node:
            put(f"{prefix}.conv.conv", conv_state_from_jax(node["conv"], False))
        elif "convtr" in node:
            put(f"{prefix}.convtr.convtr", conv_state_from_jax(node["convtr"], True))
        else:
            put(prefix, conv_state_from_jax(node, transposed))

    for name, node in params.items():
        if name in ("conv_pre", "conv_post"):
            put_conv(name, node, False)
        elif name.startswith("ups_"):
            put_conv(f"ups.{name[len('ups_'):]}", node, transposed_ups)
        elif name.startswith("resblocks_"):
            i = name[len("resblocks_"):]
            for conv_name, conv in node.items():
                # convs1_2 -> convs1.2 (ResBlock1), convs_0 -> convs.0 (ResBlock2)
                stem, j = conv_name.rsplit("_", 1)
                put_conv(f"resblocks.{i}.{stem}.{j}", conv, False)
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


def hificodec_quant_from_jax(quant: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX VQVAE's ``'quant'`` collection -> ``{module path: act_amax}``, the
    paths of the port's w8a8 convs (``encoder.resblocks.3.convs1.0``), for
    :meth:`VQVAE.load_quant`."""
    out: Dict[str, torch.Tensor] = {}
    for tower, blocks in quant.items():
        for block, convs in blocks.items():
            if not block.startswith("resblocks_"):
                raise KeyError(f"unconvertible quant entry {tower}/{block}")
            for conv_name, node in convs.items():
                stem, j = conv_name.rsplit("_", 1)
                path = f"{tower}.resblocks.{block[len('resblocks_'):]}.{stem}.{j}"
                out[path] = _t(_np32(node["act_amax"]).reshape(()))
    return out


def lm_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``RVQTokenLM`` params -> the port's ``RVQTokenLM`` state dict (torch
    ``MultiheadAttention`` / ``Linear`` / ``LayerNorm`` names)."""
    sd: Dict[str, torch.Tensor] = {"embeddings": _t(_np32(params["embeddings"]))}

    def dense(prefix, node):
        sd[f"{prefix}.weight"] = _t(np.ascontiguousarray(_np32(node["kernel"]).T))
        sd[f"{prefix}.bias"] = _t(_np32(node["bias"]))

    def norm(prefix, node):
        sd.update({f"{prefix}.{k}": v for k, v in norm_state_from_jax(node).items()})

    trunk = params["transformer"]
    norm("transformer.norm_in", trunk["norm_in"])
    layers = sorted((k for k in trunk if k.startswith("layers_")), key=lambda k: int(k[len("layers_"):]))
    for name in layers:
        node, prefix = trunk[name], f"transformer.layers.{name[len('layers_'):]}"
        attn = node["self_attn"]
        sd[f"{prefix}.self_attn.in_proj_weight"] = _t(_np32(attn["in_proj_weight"]))
        sd[f"{prefix}.self_attn.in_proj_bias"] = _t(_np32(attn["in_proj_bias"]))
        sd[f"{prefix}.self_attn.out_proj.weight"] = _t(_np32(attn["out_proj_kernel"]))
        sd[f"{prefix}.self_attn.out_proj.bias"] = _t(_np32(attn["out_proj_bias"]))
        norm(f"{prefix}.norm1", node["norm1"])
        dense(f"{prefix}.linear1", node["linear1"])
        dense(f"{prefix}.linear2", node["linear2"])
        norm(f"{prefix}.norm2", node["norm2"])
    heads = sorted((k for k in params if k.startswith("head_")), key=lambda k: int(k[len("head_"):]))
    for name in heads:
        dense(f"heads.{name[len('head_'):]}", params[name])
    unknown = set(params) - {"embeddings", "transformer", *heads}
    if unknown:
        raise KeyError(f"unconvertible LM params {sorted(unknown)}")
    return sd


def lm_train_state_from_jax(jstate: Any, state: Any) -> None:
    """Load a JAX ``LMTrainState`` (``step``, ``params``, an ``optax.adam`` state
    whose first part holds ``count``, ``mu``, ``nu``) into the port's
    ``LMTrainState`` in place; the learning rate is the trainer's, set each step."""
    state.step = int(np.asarray(jstate.step))
    state.lm.load_state_dict(lm_state_from_jax(jstate.params))
    sd = state.opt.state_dict()
    sd["state"] = _adam_moments(jstate.opt_state[0], lm_state_from_jax, state.lm)
    state.opt.load_state_dict(sd)
