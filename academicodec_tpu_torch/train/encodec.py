"""Encodec/SoundStream GAN trainer: the two-phase step of the JAX package.

One ``train_step`` (academicodec_tpu/train/encodec.py:254-316, reference
models/encodec/main_launch.py:265-359):

1. draw the bandwidth (``n_q``) and run the G phase: hinge adversarial +
   relative feature + multi-scale mel reconstruction + ``lambda_com`` x
   commit, the adversarial and feature terms gated by
   ``discriminator_iter_start``; one AdamW update of the generator;
2. regenerate the output with a freshly drawn bandwidth, with no gradient,
   and run the D phase: the hinge loss over the three discriminator families;
   one AdamW update of the discriminators;
3. the codebooks' EMA state is updated inside both generator forwards.

Kernels on the path: the quantizer's residual search and its k-means run K1
(``quant/core_vq.py``) in both forwards. The G phase's SLSTMs run under
autograd, so they take the library LSTM (K2 has no backward); the
regenerate in the D phase and ``eval_step`` run without a gradient, so
their two SLSTMs launch K2. Everything else is library calls: cuDNN convs,
``torch.stft``, ``torch.optim``.

Draws: every random choice of a step (both phases' ``n_q``, each layer's
k-means seed rows and dead-code samples, per microbatch) comes from the
state's CPU ``torch.Generator`` (:meth:`EncodecTrainer.draw`), so the card
and the CPU make the same step from the same state. A step can also be
given its draws (``draws=``), as the parity tests give it JAX's.

``accum_steps`` splits the batch into sequential microbatches whose
gradients are summed and divided by their count before one update per
phase; the codebook EMA sees the microbatches in turn (JAX :318-424).

``mixed_precision`` runs both forwards and backwards in bf16 through bf16
copies of the weights (``train/state.mp_apply``); master weights, Adam moments,
codebooks and losses stay f32. ``packed_conv`` selects a TPU lowering in
JAX and is accepted here as a no-op.

Data parallelism (``group``, a ``torch.distributed`` process group, one
rank per card; ``parallel/mesh.py``) keeps the JAX trainer's global-batch
step, which GSPMD gives it: ``train_step`` takes this rank's rows, the
rank-major block of the global batch; each microbatch is JAX's (global rows
``[i B/k, (i+1) B/k)``, ``parallel.microbatches``); the draws are made for the
global microbatch, identically on every rank from the same ``state.rng``;
each phase's gradients are averaged over the ranks once, in one flat
all-reduce, after the microbatch mean; the codebooks' EMA sums, dead-code
samples and k-means follow the global batch (``quant/core_vq.py``), and so
does the feature loss's ``mean|r|`` (``losses/gan.py``); the metrics are
global-batch means. Every rank so makes the same update and holds bitwise
the same state. ``DistributedDataParallel`` is not used: its buffer
broadcast would overwrite the ranks' codebooks with rank 0's on every
forward, hiding a drift, and its hooks do not follow the phases'
``requires_grad_`` switches or the no-grad regenerate.

The state is updated in place and returned, so a caller writes
``state, metrics = trainer.train_step(state, x)`` as with JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from academicodec_tpu_torch.losses.gan import (
    adopt_weight,
    hinge_adversarial_g_loss,
    hinge_discriminator_loss,
    relative_feature_loss,
    sim_loss,
)
from academicodec_tpu_torch.losses.mel import mel_reconstruction_loss
from academicodec_tpu_torch.models.soundstream import SoundStream, resolve_device
from academicodec_tpu_torch.nn.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    MultiScaleSTFTDiscriminator,
    reset_parameters,
)
from academicodec_tpu_torch.parallel.mesh import (
    all_reduce_mean_grads,
    all_reduce_mean_metrics,
    microbatches,
    world_size,
)
from academicodec_tpu_torch.quant.core_vq import sample_rows
from academicodec_tpu_torch.train.state import GANTrainState, make_optimizer, mp_apply, set_learning_rate

FAMILIES = ("stft", "mpd", "msd")


@dataclasses.dataclass(frozen=True)
class EncodecTrainConfig:
    """The JAX trainer's config, same fields and defaults (JAX train/encodec.py:60-112)."""

    sr: int = 16000
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    target_bandwidths: Tuple[float, ...] = (1, 1.5, 2, 4, 6, 12)
    n_filters: int = 32
    dimension: int = 512
    bins: int = 1024
    lambda_wav: float = 100.0
    lambda_adv: float = 1.0
    lambda_feat: float = 1.0
    lambda_rec: float = 1.0
    lambda_com: float = 1000.0
    discriminator_iter_start: int = 500
    mel_scale_powers: Tuple[int, ...] = tuple(range(6, 12))  # soundstream: 6..10
    feat_include_sim: bool = False  # soundstream's generator loss adds sim_loss
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.5, 0.9)
    lr_gamma: float = 0.999  # per-epoch exponential decay
    stft_filters: int = 32
    stft_n_ffts: Tuple[int, ...] = (1024, 2048, 512, 256, 128)
    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    packed_conv: bool = False  # a TPU lowering in JAX; no-op here
    accum_steps: int = 1
    mixed_precision: bool = False


class Discriminators(nn.Module):
    """The encodec/soundstream discriminator bundle (reference main_launch.py:170-178)."""

    def __init__(self, stft_filters: int = 32, stft_n_ffts: Sequence[int] = (1024, 2048, 512, 256, 128),
                 mpd_periods: Sequence[int] = (2, 3, 5, 7, 11), msd_scales: int = 3):
        super().__init__()
        self.stft_disc = MultiScaleSTFTDiscriminator(
            filters=stft_filters, n_ffts=tuple(stft_n_ffts),
            hop_lengths=tuple(n // 4 for n in stft_n_ffts), win_lengths=tuple(stft_n_ffts),
        )
        self.mpd = MultiPeriodDiscriminator("soundstream", periods=tuple(mpd_periods))
        self.msd = MultiScaleDiscriminator("soundstream", num_scales=msd_scales)

    def forward(self, x: torch.Tensor):
        return {"stft": self.stft_disc(x), "mpd": self.mpd(x), "msd": self.msd(x)}


@dataclasses.dataclass
class ForwardDraws:
    """One phase's draws: its ``n_q`` and, per microbatch, ``[n_q_max, bins]`` row draws."""

    n_q: int
    rows: List[torch.Tensor]


@dataclasses.dataclass
class StepDraws:
    g: ForwardDraws
    d: ForwardDraws


def _hinge_d(out_real, out_gen) -> torch.Tensor:
    return sum(hinge_discriminator_loss(out_real[k][0], out_gen[k][0]) for k in FAMILIES) / 3.0


def _hinge_g(out_gen) -> torch.Tensor:
    return sum(hinge_adversarial_g_loss(out_gen[k][0]) for k in FAMILIES) / 3.0


class EncodecTrainer:
    """Builds the generator and discriminators on one device and runs train/eval steps
    on batches ``[B, T]`` (``cuda`` unless the caller asks for the CPU). ``group``:
    the data-parallel process group (module docstring); the batches are then
    this rank's rows."""

    def __init__(self, config: EncodecTrainConfig, device: Union[str, torch.device] = "cuda", group=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.group = group

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> GANTrainState:
        """Seeded weights (drawn on the CPU, identical on every device), codebooks
        zero and un-inited for k-means, fresh optimizers and a CPU generator."""
        cfg = self.cfg
        root = torch.Generator().manual_seed(seed)
        g_seed, d_seed, rng_seed = (int(s) for s in torch.randint(2**62, (3,), generator=root))
        model = SoundStream(
            n_filters=cfg.n_filters, dimension=cfg.dimension, ratios=cfg.ratios, sample_rate=cfg.sr,
            target_bandwidths=cfg.target_bandwidths, bins=cfg.bins, device="cpu", seed=g_seed,
        )
        model.quantizer.vq.init_training_state()
        discs = Discriminators(cfg.stft_filters, cfg.stft_n_ffts, cfg.mpd_periods, cfg.msd_scales)
        reset_parameters(discs, torch.Generator().manual_seed(d_seed))
        model.to(self.device)
        discs.to(self.device)
        return GANTrainState(
            step=0, generator=model, discriminators=discs,
            g_opt=self._optimizer(model), d_opt=self._optimizer(discs),
            rng=torch.Generator().manual_seed(rng_seed),
        )

    def _optimizer(self, module: nn.Module) -> torch.optim.Optimizer:
        return make_optimizer("adamw", module.parameters(), self.cfg.lr, *self.cfg.betas,
                              fused=self.device.type == "cuda")

    def set_epoch_lr(self, state: GANTrainState, epoch: int) -> GANTrainState:
        """ExponentialLR: ``lr = lr0 * gamma^epoch``, stepped per epoch."""
        lr = self.cfg.lr * (self.cfg.lr_gamma**epoch)
        set_learning_rate(state.g_opt, lr)
        set_learning_rate(state.d_opt, lr)
        return state

    # ------------------------------------------------------------------
    def draw(self, state: GANTrainState, x_shape: Tuple[int, int]) -> StepDraws:
        """The step's draws from ``state.rng`` for a global batch of ``x_shape``: the
        G phase's ``n_q``, the D phase's, then each phase's row draws per
        microbatch, into the global microbatch's latent frames."""
        model, k = state.generator, self.cfg.accum_steps
        n = (x_shape[0] // k) * math.ceil(x_shape[1] / model.hop_length)  # latent frames of a microbatch
        vq = model.quantizer.vq

        def rows():
            return torch.stack([sample_rows(state.rng, n, vq.codebook_size) for _ in range(vq.num_quantizers)])

        n_q_g, n_q_d = model.sample_n_q(state.rng), model.sample_n_q(state.rng)
        return StepDraws(ForwardDraws(n_q_g, [rows() for _ in range(k)]),
                         ForwardDraws(n_q_d, [rows() for _ in range(k)]))

    def _gen_forward(self, model: SoundStream, x: torch.Tensor, n_q: int, rows: Optional[torch.Tensor]):
        """The generator's training forward, in bf16 under ``mixed_precision`` (outputs upcast to f32)."""
        kw = dict(n_q=n_q, training=True, draws=rows, group=self.group)
        if self.cfg.mixed_precision:
            return mp_apply(model, x, **kw)
        return model(x, **kw)

    def _disc_all(self, discs: nn.Module, x: torch.Tensor):
        if self.cfg.mixed_precision:
            return mp_apply(discs, x)
        return discs(x)

    def _g_loss(self, out_real, out_gen, x, g_x, commit, step: int):
        cfg = self.cfg
        adv = _hinge_g(out_gen)
        feat_terms = []
        for k in FAMILIES:
            t = relative_feature_loss(out_real[k][1], out_gen[k][1], self.group)
            if cfg.feat_include_sim:
                t = t + sim_loss(out_real[k][0], out_gen[k][0])
            feat_terms.append(t)
        feat = sum(feat_terms) / 3.0
        rec = mel_reconstruction_loss(x, g_x, cfg.sr, scale_powers=cfg.mel_scale_powers, lambda_wav=cfg.lambda_wav)
        disc_factor = adopt_weight(cfg.lambda_adv, step, cfg.discriminator_iter_start)
        fm_wt = 0.0 if disc_factor == 0.0 else cfg.lambda_feat
        total = rec + disc_factor * adv + fm_wt * feat + cfg.lambda_com * commit
        return total, dict(rec_loss=rec, adv_g_loss=adv, feat_loss=feat, commit_loss=commit)

    # ------------------------------------------------------------------
    def train_step(self, state: GANTrainState, x: torch.Tensor, draws: Optional[StepDraws] = None,
                   return_codes: bool = False):
        """One G update and one D update on ``x [B, T]`` (this rank's rows under a
        group) -> ``(state, metrics)`` (with ``return_codes``, also ``{"g": [...],
        "d": [...]}``, each phase's codes of each microbatch, this rank's rows).
        Metrics are 0-dim f32 tensors on the device, global-batch means, read by
        the caller when it logs."""
        cfg = self.cfg
        k = cfg.accum_steps
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        T = x.shape[1]
        if T % state.generator.hop_length:
            raise ValueError(f"segments of {T} samples are not a multiple of the hop length "
                             f"{state.generator.hop_length}: the output would not match the input's length")
        xm = microbatches(x, k, self.group)
        if draws is None:
            draws = self.draw(state, (x.shape[0] * world_size(self.group), T))
        model, discs = state.generator, state.discriminators
        disc_factor = adopt_weight(cfg.lambda_adv, state.step, cfg.discriminator_iter_start)

        # ---- generator phase: gradients for the generator only ----
        state.g_opt.zero_grad(set_to_none=True)
        discs.requires_grad_(False)
        metrics_k, codes_k = [], {"g": [], "d": []}
        try:
            for i in range(k):
                g_x, commit, codes = self._gen_forward(model, xm[i], draws.g.n_q, draws.g.rows[i])
                with torch.no_grad():
                    out_real = self._disc_all(discs, xm[i])
                out_gen = self._disc_all(discs, g_x)
                total, metrics = self._g_loss(out_real, out_gen, xm[i], g_x, commit, state.step)
                total.backward()
                metrics_k.append(dict(loss_g=total.detach(), **{n: v.detach() for n, v in metrics.items()}))
                codes_k["g"].append(codes)
        finally:
            discs.requires_grad_(True)
        self._mean_grads(model, k)
        all_reduce_mean_grads(model, self.group)
        state.g_opt.step()

        # ---- discriminator phase, on a fresh no-grad generator forward ----
        state.d_opt.zero_grad(set_to_none=True)
        d_losses = []
        for i in range(k):
            with torch.no_grad():
                g_x2, _, codes = self._gen_forward(model, xm[i], draws.d.n_q, draws.d.rows[i])
            codes_k["d"].append(codes)
            loss_d = disc_factor * _hinge_d(self._disc_all(discs, xm[i]), self._disc_all(discs, g_x2))
            loss_d.backward()
            d_losses.append(loss_d.detach())
        self._mean_grads(discs, k)
        all_reduce_mean_grads(discs, self.group)
        state.d_opt.step()

        state.step += 1
        metrics = {n: torch.stack([m[n] for m in metrics_k]).mean() for n in metrics_k[0]}
        metrics["loss_d"] = torch.stack(d_losses).mean()
        metrics = all_reduce_mean_metrics(metrics, self.group)
        return (state, metrics, codes_k) if return_codes else (state, metrics)

    @staticmethod
    def _mean_grads(module: nn.Module, k: int) -> None:
        if k > 1:
            for p in module.parameters():
                if p.grad is not None:
                    p.grad.div_(k)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, state: GANTrainState, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The validation criterion (reference main_launch.py:365-429): every layer,
        no EMA update, ``lambda_rec``-weighted reconstruction and sim losses;
        global-batch means under a group."""
        cfg = self.cfg
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        model, discs = state.generator, state.discriminators
        g_x, commit, _ = model(x, n_q=model.n_q, training=False)
        out_real, out_gen = discs(x), discs(g_x)
        adv = _hinge_g(out_gen)
        feat = sum(
            relative_feature_loss(out_real[k][1], out_gen[k][1], self.group) + sim_loss(out_real[k][0], out_gen[k][0])
            for k in FAMILIES
        ) / 3.0
        rec = mel_reconstruction_loss(x, g_x, cfg.sr, scale_powers=cfg.mel_scale_powers, lambda_wav=cfg.lambda_wav)
        total = cfg.lambda_com * commit + cfg.lambda_adv * adv + cfg.lambda_feat * feat + cfg.lambda_rec * rec
        return all_reduce_mean_metrics(dict(
            valid_loss_g=total, valid_loss_d=_hinge_d(out_real, out_gen), rec_loss=rec, adv_g_loss=adv,
            feat_loss=feat, commit_loss=commit), self.group)
