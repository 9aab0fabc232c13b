"""Token-LM trainer: teacher-forced cross entropy over RVQ/GRVQ code streams.

Trains the entropy model (``models/lm.RVQTokenLM``) that LM-coded
compression (``codec/lm_compress.py``, ``--lm`` of both serving CLIs)
consumes. Codes come from a frozen codec's ``encode`` (``cli/train_lm.py``):
the codec first, the LM on its tokens. The loss is the mean cross entropy
over all ``n_q`` streams, each frame predicted from the previous frames
with a BOS of ``bins``; ``bits_per_token`` is that loss in bits, which
bounds the coded rate.

Adam with betas (0.9, 0.95) and optax's eps 1e-8. With ``decay_steps`` the
learning rate follows optax's ``warmup_cosine_decay_schedule`` (from 0 over
``min(warmup_steps, decay_steps // 10)`` steps up to ``lr``, then a cosine
to ``0.05 lr`` at ``decay_steps``), evaluated at the count of updates made
before the step, as optax evaluates it; else it is constant.

Behavioral parity target: academicodec_tpu/train/lm.py:24-104.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from academicodec_tpu_torch.models.lm import RVQTokenLM
from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.train.state import make_optimizer, set_learning_rate


@dataclasses.dataclass(frozen=True)
class LMTrainConfig:
    """The JAX trainer's config, same fields and defaults (JAX train/lm.py:24-40)."""

    n_q: int = 8
    bins: int = 1024
    dim: int = 200
    num_heads: int = 8
    num_layers: int = 5
    past_context: int = 1000
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    decay_steps: Optional[int] = None
    warmup_steps: int = 100


def warmup_cosine_decay(count: int, peak: float, warmup_steps: int, decay_steps: int, end: float) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup_steps, decay_steps, end)``
    at ``count``: linear from 0 to ``peak`` over ``warmup_steps``, then
    ``peak ((1 - a) (1 + cos(pi t / n)) / 2 + a)`` with ``a = end / peak``,
    ``t = min(count - warmup_steps, n)``, ``n = decay_steps - warmup_steps``."""
    if count < warmup_steps:
        return peak * count / warmup_steps
    n = decay_steps - warmup_steps
    alpha = end / peak if peak else 0.0
    t = min(count - warmup_steps, n)
    return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / n)) + alpha)


@dataclasses.dataclass
class LMTrainState:
    step: int
    lm: RVQTokenLM
    opt: torch.optim.Optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "lm": self.lm.state_dict(), "optimizer": self.opt.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd["step"])
        self.lm.load_state_dict(sd["lm"])
        self.opt.load_state_dict(sd["optimizer"])


class LMTrainer:
    """Builds the LM on one device (``cuda`` unless the caller asks for the CPU)
    and runs teacher-forced steps on codes ``[B, T, n_q]``."""

    def __init__(self, config: LMTrainConfig, device: Union[str, torch.device] = "cuda"):
        self.cfg = config
        self.device = resolve_device(device)

    def learning_rate(self, step: int) -> float:
        """The learning rate of the update that follows ``step`` earlier updates."""
        cfg = self.cfg
        if cfg.decay_steps is None:
            return cfg.lr
        warmup = min(cfg.warmup_steps, cfg.decay_steps // 10)
        return warmup_cosine_decay(step, cfg.lr, warmup, cfg.decay_steps, 0.05 * cfg.lr)

    def init_state(self, seed: int = 0) -> LMTrainState:
        cfg = self.cfg
        lm = RVQTokenLM(n_q=cfg.n_q, bins=cfg.bins, dim=cfg.dim, num_heads=cfg.num_heads,
                        num_layers=cfg.num_layers, past_context=cfg.past_context, device=self.device, seed=seed)
        opt = make_optimizer("adam", lm.parameters(), cfg.lr, *cfg.betas, fused=self.device.type == "cuda")
        return LMTrainState(step=0, lm=lm, opt=opt)

    def loss(self, lm: RVQTokenLM, codes: torch.Tensor) -> torch.Tensor:
        """Mean cross entropy of ``codes [B, T, n_q]`` given the frames before each."""
        B, _, n_q = codes.shape
        bos = torch.full((B, 1, n_q), self.cfg.bins, dtype=codes.dtype, device=codes.device)
        prev = torch.cat([bos, codes[:, :-1]], dim=1)
        logits, _, _ = lm(prev)
        logp = F.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, codes[..., None]).mean()

    def train_step(self, state: LMTrainState, codes) -> Tuple[LMTrainState, Dict[str, torch.Tensor]]:
        """One Adam update on ``codes [B, T, n_q]`` -> ``(state, {'ce_loss',
        'bits_per_token'})``, 0-dim f32 tensors on the device."""
        codes = torch.as_tensor(codes).to(device=self.device, dtype=torch.long)
        set_learning_rate(state.opt, self.learning_rate(state.step))
        state.opt.zero_grad(set_to_none=True)
        loss = self.loss(state.lm, codes)
        loss.backward()
        state.opt.step()
        state.step += 1
        loss = loss.detach()
        return state, dict(ce_loss=loss, bits_per_token=loss / math.log(2.0))
