"""GAN training state: the generator, the discriminators, their optimizers and the draws.

The JAX package keeps one pytree (academicodec_tpu/train/state.py); the port
keeps the same parts in a :class:`GANTrainState`: the step, both modules,
both ``torch.optim`` optimizers and the CPU ``torch.Generator`` that every
random draw of a step comes from.

Optimizers follow optax's semantics: ``optax.adamw`` defaults to weight
decay 1e-4 on every leaf, eps 1e-8 and eps_root 0, which is the update of
``torch.optim.AdamW(..., weight_decay=1e-4)`` (tests/test_torch_train.py
holds one against the other); ``adam`` has no decay. The learning rate is a
hyperparameter set between steps (:func:`set_learning_rate`), as
``optax.inject_hyperparams`` makes it in JAX.

Mixed precision (JAX ``mp_cast``/``f32_cast``): :func:`mp_apply` runs a
module through ``torch.func.functional_call`` on bf16 copies of its f32
parameters (:func:`mp_params`, cast differentiably, so the gradients land on
the f32 master weights) and of its input, and upcasts its outputs; buffers
(the codebooks' EMA state, the spectral norm's ``u``), the Adam moments and
every loss reduction stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable

import torch
import torch.nn as nn

OPTAX_WEIGHT_DECAY = 1e-4  # optax.adamw's default
OPTAX_EPS = 1e-8


def make_optimizer(kind: str, params: Iterable[nn.Parameter], learning_rate: float, b1: float, b2: float,
                   fused: bool = False) -> torch.optim.Optimizer:
    """``optax.inject_hyperparams(optax.adamw | optax.adam)(learning_rate, b1, b2)``
    as a ``torch.optim`` optimizer; ``fused`` takes torch's fused CUDA update."""
    kw = dict(lr=learning_rate, betas=(b1, b2), eps=OPTAX_EPS)
    if fused:
        kw["fused"] = True
    if kind == "adamw":
        return torch.optim.AdamW(params, weight_decay=OPTAX_WEIGHT_DECAY, **kw)
    if kind == "adam":
        return torch.optim.Adam(params, weight_decay=0.0, **kw)
    raise ValueError(f"unknown optimizer {kind!r}")


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def mp_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """bf16 views of ``module``'s f32 parameters for ``functional_call`` (the
    cast is differentiable)."""
    return {k: (p.to(torch.bfloat16) if p.dtype == torch.float32 else p) for k, p in module.named_parameters()}


def mp_apply(module: nn.Module, x: torch.Tensor, **kwargs) -> Any:
    """``module(x, **kwargs)`` in bf16 (JAX's ``mp_cast`` of params and input):
    bf16 copies of its f32 parameters (:func:`mp_params`, differentiable) and of
    ``x``, its own buffers; every bf16 output upcast to f32 (:func:`f32_cast`)."""
    return f32_cast(torch.func.functional_call(module, mp_params(module), (x.to(torch.bfloat16),), kwargs))


def f32_cast(tree: Any) -> Any:
    """Upcast every bf16 tensor of a nested list/tuple/dict so losses reduce in f32."""
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    if isinstance(tree, dict):
        return {k: f32_cast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(f32_cast(v) for v in tree)
    return tree


@dataclasses.dataclass
class GANTrainState:
    step: int
    generator: nn.Module
    discriminators: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    rng: torch.Generator  # CPU: every draw of a step, identical on the card and the CPU

    def state_dict(self) -> Dict[str, Any]:
        """The whole state as tensors and plain containers (``torch.load(weights_only=True)``
        reads it). The generator's part is in the reference's layout
        (:meth:`generator_state_dict`), so that a serving loader takes the file."""
        return {
            "step": self.step,
            **self.generator_state_dict(),
            "discriminators": self.discriminators.state_dict(),
            "optimizer_g": self.g_opt.state_dict(),
            "optimizer_d": self.d_opt.state_dict(),
            "rng": self.rng.get_state(),
        }

    def generator_state_dict(self) -> Dict[str, Any]:
        """The generator under ``soundstream``, as in a reference ``latest.pth``."""
        return {"soundstream": self.generator.state_dict()}

    def load_generator_state_dict(self, sd: Dict[str, Any]) -> None:
        self.generator.load_state_dict(sd["soundstream"])

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd["step"])
        self.load_generator_state_dict(sd)
        self.discriminators.load_state_dict(sd["discriminators"])
        self.g_opt.load_state_dict(sd["optimizer_g"])
        self.d_opt.load_state_dict(sd["optimizer_d"])
        self.rng.set_state(sd["rng"])
