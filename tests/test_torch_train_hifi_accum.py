"""The HiFi-Codec trainer's ``accum_steps`` and ``mixed_precision``, on the CPU.

``accum_steps=2`` from one converted JAX state against JAX's
``accum_steps=2`` step (the tolerances of tests/test_torch_train_hifi_step.py)
and against the port's monolithic step: for this family the accumulated
step is the monolithic one up to reduction order (every loss a batch mean,
the codebooks trained by gradient, the spectral norm's ``u`` stepped from
the same pre-step ``(W, u)`` in each microbatch), as tests/test_grad_accum.py:54
holds JAX's: losses within 1e-5 relative, each moment within 1e-3 of its
leaf's own max, ``u`` atol 1e-6. A mixed-precision step stays near the f32 step,
as tests/test_mixed_precision.py:90 holds JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.train.hificodec import HiFiCodecTrainer as JTrainer

from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainer
from academicodec_tpu_torch.utils.convert import hificodec_train_state_from_jax
from tests.test_torch_train_hifi import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train_hifi_step import (
    LOSSES,
    check_step,
    configs,
    jax_state_from_port,
    moments,
    seeded_batch,
    start,
)


@pytest.fixture(scope="module")
def seed_state():
    trainer = HiFiCodecTrainer(configs()[0], device="cpu")
    x = seeded_batch(1)
    return start(trainer, x, seed=1), x


def copy_of(trainer, seed):
    state = trainer.init_state(0)
    state.generator.load_reference(seed.generator.reference_state_dict())
    state.discriminators.load_state_dict(seed.discriminators.state_dict())
    return state


def test_accum_step_matches_jax_and_the_monolithic_step(seed_state):
    seed, x = seed_state
    cfg, jcfg = configs(accum_steps=2)
    trainer, jtrainer = HiFiCodecTrainer(cfg, device="cpu"), JTrainer(jcfg)
    jstate = jax_state_from_port(jtrainer, seed)
    state = trainer.init_state(3)
    hificodec_train_state_from_jax(jstate, state)
    jnew, jmetrics = jtrainer.train_step(jstate, jnp.asarray(x))
    state, metrics = trainer.train_step(state, x)
    check_step(state, metrics, jnew, jmetrics, cfg.learning_rate)

    mono_trainer = HiFiCodecTrainer(configs()[0], device="cpu")
    mono, mono_metrics = mono_trainer.train_step(copy_of(mono_trainer, seed), x)
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(mono_metrics[k]), rtol=1e-5, err_msg=k)
    for module, opt, mono_module, mono_opt in ((state.generator, state.g_opt, mono.generator, mono.g_opt),
                                               (state.discriminators, state.d_opt, mono.discriminators,
                                                mono.d_opt)):
        got, want = moments(opt, module), moments(mono_opt, mono_module)
        for name, (mu, nu) in got.items():
            for g, ref in ((mu, want[name][0]), (nu, want[name][1])):
                assert (g - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-30, name
    for a, b in zip(state.discriminators.spectral_u(), mono.discriminators.spectral_u(), strict=True):
        assert torch.allclose(a, b, atol=1e-6, rtol=0)


def test_mixed_precision_step_stays_near_f32(seed_state):
    """A bf16 step from the same state: finite, its generator loss within 5% of
    the f32 step's, and the state f32 throughout (weights, Adam moments, the
    spectral u, which steps from the bf16 weights, as JAX's does)."""
    seed, x = seed_state
    trainer, ref = (HiFiCodecTrainer(configs(mixed_precision=True)[0], device="cpu"),
                    HiFiCodecTrainer(configs()[0], device="cpu"))
    state, m = trainer.train_step(copy_of(trainer, seed), x)
    f32, m32 = ref.train_step(copy_of(ref, seed), x)
    assert all(np.isfinite(float(m[k])) for k in LOSSES)
    rel = abs(float(m["loss_gen_all"]) - float(m32["loss_gen_all"])) / (1 + abs(float(m32["loss_gen_all"])))
    assert rel < 0.05, rel
    tensors = [*state.generator.parameters(), *state.discriminators.parameters(), *state.discriminators.buffers()]
    tensors += [t for opt in (state.g_opt, state.d_opt) for s in opt.state.values() for t in s.values()
                if torch.is_tensor(t) and t.is_floating_point()]
    assert all(t.dtype == torch.float32 for t in tensors)
    for u, u32 in zip(state.discriminators.spectral_u(), f32.discriminators.spectral_u(), strict=True):
        assert abs(u.norm().item() - 1.0) < 1e-5 and (u - u32).abs().max() < 1e-2
