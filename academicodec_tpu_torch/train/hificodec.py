"""HiFi-Codec GAN trainer: the D-then-G step of the JAX package.

One ``train_step`` (academicodec_tpu/train/hificodec.py:193-255, reference
models/hificodec/train.py:205-390):

1. a generator forward with no gradient, for the D phase;
2. the D phase: LS-GAN losses of the multi-period, multi-scale and MS-STFT
   discriminators on the real batch, which steps the spectral norm's ``u``
   (once a step, JAX's mutable apply), and on the generated one with that
   new ``u``; one Adam update of the discriminators;
3. a second, differentiable generator forward for the G phase:
   ``hifigan_mel_losses`` + ``lambda_q`` x the GRVQ loss + LS-GAN + the
   absolute feature loss x2 of each family, against the updated
   discriminators with the new ``u``, not stepping it; one Adam update of
   the generator (encoder, GRVQ codebooks, decoder).

Kernels on the path: the no-grad forward of step 1 and ``eval_step`` run
K4 in the encoder's narrow stage and K3 in the generator's two narrow
stages on the card (``nn/hifigan.py``). The G phase runs every stage
unfused under autograd, as the JAX trainer does (K3/K4 have no backward).
Everything else is library calls: cuDNN convs, ``torch.stft``,
``torch.optim``. No step draws anything: GRVQ has no k-means and no dead
codes, and the spectral norm's power iteration does not depend on the data.

``accum_steps`` splits the batch into sequential microbatches whose
gradients are summed and divided by their count before one update per
phase; each microbatch's D phase steps ``u`` from the same pre-step
``(W, u)``, and the last result is kept (JAX :257-351), so the step equals
the monolithic one up to reduction order. ``mixed_precision`` runs the
forwards and backwards in bf16 through bf16 copies of the weights
(``train/state.mp_apply``); master weights, Adam moments, ``u`` and every
loss reduction stay f32.

Data parallelism (``group``, a ``torch.distributed`` process group, one
rank per card; ``parallel/mesh.py``) keeps the JAX trainer's global-batch
step: ``train_step`` takes this rank's rows of the global batch, each
microbatch is JAX's (``parallel.microbatches``), each phase's gradients are
averaged over the ranks once, after the microbatch mean, and the metrics are
global-batch means. Every loss of the step is a plain mean over the batch,
so nothing else crosses ranks: the GRVQ codebooks are learned parameters
(no EMA), and the spectral norm's ``u`` steps as a function of the weights
alone, which every rank holds alike.

The state is updated in place and returned, so a caller writes
``state, metrics = trainer.train_step(state, y)`` as with JAX.
``train_step`` is the span ``train.step`` over ``train.g_phase`` and
``train.d_phase`` (``utils/profiling.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.nn as nn

from academicodec_tpu_torch.losses.gan import absolute_feature_loss, ls_discriminator_loss, ls_generator_loss
from academicodec_tpu_torch.losses.mel import hifigan_mel_losses
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.nn.conv import Conv1d
from academicodec_tpu_torch.nn.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    MultiScaleSTFTDiscriminator,
    reset_parameters,
)
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig, invalidate_packed
from academicodec_tpu_torch.parallel.mesh import all_reduce_mean_grads, all_reduce_mean_metrics, microbatches
from academicodec_tpu_torch.train.state import GANTrainState, make_optimizer, mp_apply, set_learning_rate
from academicodec_tpu_torch.utils import profiling

# the order of the JAX trainer's loss sums
FAMILIES = ("msd", "mpd", "mstftd")


@dataclasses.dataclass(frozen=True)
class HiFiCodecTrainConfig:
    """The JAX trainer's config, same fields and defaults (JAX train/hificodec.py:47-79)."""

    model: HiFiCodecConfig = HiFiCodecConfig()
    learning_rate: float = 2e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.9
    lr_decay: float = 0.98  # per epoch
    lambda_q: float = 10.0
    stft_filters: int = 32
    stft_n_ffts: Tuple[int, ...] = (1024, 2048, 512, 256, 128)
    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    accum_steps: int = 1
    mixed_precision: bool = False


class Discriminators(nn.Module):
    """Multi-period + multi-scale (hificodec flavor) + MS-STFT (reference train.py:77-79)."""

    def __init__(self, stft_filters: int = 32, stft_n_ffts: Sequence[int] = (1024, 2048, 512, 256, 128),
                 mpd_periods: Sequence[int] = (2, 3, 5, 7, 11), msd_scales: int = 3):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator("hificodec", periods=tuple(mpd_periods))
        self.msd = MultiScaleDiscriminator("hificodec", num_scales=msd_scales)
        self.mstftd = MultiScaleSTFTDiscriminator(
            filters=stft_filters, n_ffts=tuple(stft_n_ffts),
            hop_lengths=tuple(n // 4 for n in stft_n_ffts), win_lengths=tuple(stft_n_ffts),
        )

    def forward(self, x: torch.Tensor, advance: bool = False):
        """``advance``: step the spectral norm's ``u`` in this call."""
        return {"mpd": self.mpd(x), "msd": self.msd(x, advance), "mstftd": self.mstftd(x)}

    def spectral_u(self) -> List[torch.Tensor]:
        """The power-iteration vectors of every spectral-normed conv."""
        return [m.weight_u for m in self.modules() if isinstance(m, Conv1d) and m.norm == "spectral_norm"]


class HiFiCodecTrainState(GANTrainState):
    """The trainer's state; its file holds the generator as a reference ``g_*``
    dict (``generator``, ``encoder``, ``quantizer``), so that
    ``VQVAE.load_reference``, ``api.load_codec`` and ``cli/extract_tokens.py``
    take it as they take a ``g_*`` file."""

    def generator_state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return self.generator.reference_state_dict()

    def load_generator_state_dict(self, sd) -> None:
        self.generator.load_reference(sd)


class HiFiCodecTrainer:
    """Builds the VQVAE and the discriminators on one device and runs train/eval
    steps on batches ``[B, T]`` (``cuda`` unless the caller asks for the CPU).
    ``group``: the data-parallel process group (module docstring); the batches
    are then this rank's rows."""

    def __init__(self, config: HiFiCodecTrainConfig, device: Union[str, torch.device] = "cuda", group=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.group = group

    def init_state(self, seed: int = 0) -> HiFiCodecTrainState:
        """Seeded weights (drawn on the CPU, identical on every device), fresh
        Adam optimizers."""
        cfg = self.cfg
        root = torch.Generator().manual_seed(seed)
        g_seed, d_seed, rng_seed = (int(s) for s in torch.randint(2**62, (3,), generator=root))
        model = VQVAE(cfg.model, device=self.device, seed=g_seed)
        discs = Discriminators(cfg.stft_filters, cfg.stft_n_ffts, cfg.mpd_periods, cfg.msd_scales)
        reset_parameters(discs, torch.Generator().manual_seed(d_seed))
        discs.to(self.device)
        return HiFiCodecTrainState(
            step=0, generator=model, discriminators=discs,
            g_opt=self._optimizer(model), d_opt=self._optimizer(discs),
            rng=torch.Generator().manual_seed(rng_seed),
        )

    def _optimizer(self, module: nn.Module) -> torch.optim.Optimizer:
        cfg = self.cfg
        return make_optimizer("adam", module.parameters(), cfg.learning_rate, cfg.adam_b1, cfg.adam_b2,
                              fused=self.device.type == "cuda")

    def set_epoch_lr(self, state: HiFiCodecTrainState, epoch: int) -> HiFiCodecTrainState:
        """ExponentialLR: ``lr = lr0 * lr_decay^epoch``, stepped per epoch."""
        lr = self.cfg.learning_rate * (self.cfg.lr_decay**epoch)
        set_learning_rate(state.g_opt, lr)
        set_learning_rate(state.d_opt, lr)
        return state

    def _mel_cfg(self) -> dict:
        h = self.cfg.model
        return dict(n_fft=h.n_fft, num_mels=h.num_mels, sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                    win_size=h.win_size, fmin=h.fmin, fmax_for_loss=h.fmax_for_loss)

    def _gen(self, model: VQVAE, y: torch.Tensor):
        """The generator's training forward, bf16 under ``mixed_precision`` (outputs in f32)."""
        if self.cfg.mixed_precision:
            return mp_apply(model, y, training=True)
        return model(y, training=True)

    def _disc(self, discs: Discriminators, y: torch.Tensor, advance: bool = False):
        if self.cfg.mixed_precision:
            return mp_apply(discs, y, advance=advance)
        return discs(y, advance)

    # ------------------------------------------------------------------
    @profiling.span("train.step")
    def train_step(self, state: HiFiCodecTrainState, y: torch.Tensor):
        """One D update, then one G update, on ``y [B, T]`` (this rank's rows under a
        group) -> ``(state, metrics)``: ``loss_gen_all``, ``loss_disc_all``,
        ``loss_q``, ``mel_error``, 0-dim f32 tensors on the device (means over the
        microbatches and the ranks)."""
        k = self.cfg.accum_steps
        y = torch.as_tensor(y).to(device=self.device, dtype=torch.float32)
        T = y.shape[1]
        model, discs = state.generator, state.discriminators
        if T % model.hop_length:
            raise ValueError(f"segments of {T} samples are not a multiple of the hop length {model.hop_length}: "
                             "the output would not match the input's length")
        ym = microbatches(y, k, self.group)

        # ---- discriminator phase, on a no-grad generator forward ----
        with profiling.span("train.d_phase"):
            state.d_opt.zero_grad(set_to_none=True)
            us = discs.spectral_u()
            u0 = [u.clone() for u in us]
            d_losses = []
            for i in range(k):
                with torch.no_grad():
                    y_g, _, _ = self._gen(model, ym[i])
                    for u, u_start in zip(us, u0):  # every microbatch steps u from the pre-step u
                        u.copy_(u_start)
                out_real = self._disc(discs, ym[i], advance=True)
                out_gen = self._disc(discs, y_g)
                loss_d = 0.0
                for name in FAMILIES:
                    loss_d = loss_d + ls_discriminator_loss(out_real[name][0], out_gen[name][0])[0]
                loss_d.backward()
                d_losses.append(loss_d.detach())
            _mean_grads(discs, k)
            all_reduce_mean_grads(discs, self.group)
            state.d_opt.step()

        # ---- generator phase, against the updated discriminators and the new u ----
        with profiling.span("train.g_phase"):
            state.g_opt.zero_grad(set_to_none=True)
            discs.requires_grad_(False)
            g_metrics = []
            try:
                for i in range(k):
                    y_hat, loss_q, _ = self._gen(model, ym[i])
                    loss_mel, mel_error = hifigan_mel_losses(ym[i], y_hat, None, **self._mel_cfg())
                    with torch.no_grad():
                        out_real = self._disc(discs, ym[i])
                    out_gen = self._disc(discs, y_hat)
                    total = loss_mel + self.cfg.lambda_q * loss_q
                    for name in FAMILIES:
                        gen_l, _ = ls_generator_loss(out_gen[name][0])
                        total = total + gen_l + absolute_feature_loss(out_real[name][1], out_gen[name][1])
                    total.backward()
                    g_metrics.append((total.detach(), loss_q.detach(), mel_error.detach()))
            finally:
                discs.requires_grad_(True)
            _mean_grads(model, k)
            all_reduce_mean_grads(model, self.group)
            state.g_opt.step()
            invalidate_packed(model)  # the fused optimizer leaves the version counters as they were

        state.step += 1
        loss_g, loss_q, mel_error = (torch.stack(c).mean() for c in zip(*g_metrics))
        return state, all_reduce_mean_metrics(dict(
            loss_gen_all=loss_g, loss_disc_all=torch.stack(d_losses).mean(), loss_q=loss_q, mel_error=mel_error),
            self.group)

    @torch.no_grad()
    def eval_step(self, state: HiFiCodecTrainState, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Validation mel error and GRVQ loss (reference train.py:340-386), f32;
        global-batch means under a group."""
        y = torch.as_tensor(y).to(device=self.device, dtype=torch.float32)
        y_hat, loss_q, _ = state.generator(y, training=False)
        _, mel_error = hifigan_mel_losses(y, y_hat, None, **self._mel_cfg())
        return all_reduce_mean_metrics(dict(val_mel_error=mel_error, loss_q=loss_q), self.group)


def _mean_grads(module: nn.Module, k: int) -> None:
    if k > 1:
        for p in module.parameters():
            if p.grad is not None:
                p.grad.div_(k)
