"""The port's HiFi-Codec trainer against the JAX trainer: one whole step, on the CPU.

One state is made by the port (``HiFiCodecTrainer.init_state``, its GRVQ
codebooks spread over the encoder's latents so that codes spread), carried to
JAX (``torch_import.import_hificodec`` and :func:`discs_to_jax`, with fresh
optax states), and carried back with
``utils/convert.hificodec_train_state_from_jax``, so both packages step from
one converted JAX state. Shapes are tests/test_grad_accum.py's tiny
HiFi-Codec, its discriminators and its ``[4, 512]`` batch.

Tolerances: losses rtol 1e-4; the GRVQ codes equal; each leaf of Adam's
moments within 5e-3 of the larger of its max |moment| and a hundredth of its
phase's (``chip_smoke.TRAIN_CROSS_LIMITS``' rule: a leaf that is one sum with
cancellation, such as ``generator.conv_post.bias``, carries f32 noise of its
terms' size, ~1e-3 of its own here, and the port's steps agree with each
other closer than with JAX's); the spectral ``u`` atol 1e-6; parameters
atol 1e-6 + 2e-3 x ``lr`` where JAX's gradient is at least 1e-3 of its leaf's
max |g|, and within ``2 lr`` everywhere (Adam's first update is about
``lr x sign(g)``, and a gradient near 0 may take either sign in the two
packages' roundings).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.nn.hifigan import HiFiCodecConfig as JHiFiCodecConfig
from academicodec_tpu.train.hificodec import HiFiCodecTrainConfig as JConfig
from academicodec_tpu.train.hificodec import HiFiCodecTrainer as JTrainer
from academicodec_tpu.train.state import GANTrainState as JState
from academicodec_tpu.utils.torch_import import import_hificodec

from chip_smoke import latent_frames, spread_codebooks
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig, HiFiCodecTrainer
from academicodec_tpu_torch.utils.convert import (
    discriminators_state_from_jax,
    hificodec_params_from_jax,
    hificodec_train_state_from_jax,
)
from tests.test_torch_train_hifi import TINY_DISCS, TINY_MODEL, one_torch_thread  # noqa: F401 (autouse)

BATCH, T = 4, 512
LOSSES = ("loss_gen_all", "loss_disc_all", "loss_q", "mel_error")


def seeded_batch(seed=0):
    return (np.random.default_rng(seed).standard_normal((BATCH, T)) * 0.3).astype(np.float32)


def discs_to_jax(discs):
    """The port's discriminator state dict as JAX ``(params, spectral)`` trees
    (the inverse of ``discriminators_state_from_jax``)."""
    names = {"weight": "kernel", "weight_v": "kernel_v", "weight_g": "kernel_g", "bias": "bias"}
    params, spectral = {}, {}
    for key, value in discs.state_dict().items():
        parts = key.split(".")
        path, leaf, i = [parts[0]], parts[-1], 1
        while i < len(parts) - 1:
            if i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
                path.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        a = value.numpy()
        tree, name = (spectral, "kernel_u") if leaf == "weight_u" else (params, names[leaf])
        if leaf not in ("bias", "weight_u"):
            a = np.transpose(a, (2, 3, 1, 0) if a.ndim == 4 else (2, 1, 0))
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(a)
    return params, spectral


def jax_state_from_port(jtrainer, state) -> JState:
    g_vars = import_hificodec({k: {n: t.numpy() for n, t in v.items()}
                               for k, v in state.generator.reference_state_dict().items()})
    d_params, spectral = discs_to_jax(state.discriminators)
    return JState.create(jax.tree_util.tree_map(jnp.asarray, g_vars), {"params": d_params, "spectral": spectral},
                         jtrainer.g_tx, jtrainer.d_tx, jax.random.PRNGKey(0))


def configs(**kw):
    port = HiFiCodecTrainConfig(model=HiFiCodecConfig(**TINY_MODEL), **TINY_DISCS, **kw)
    return port, JConfig(model=JHiFiCodecConfig(**TINY_MODEL), **TINY_DISCS, **kw)


def start(trainer, x, seed=0):
    """A seeded port state with the codebooks spread over ``x``'s latents."""
    state = trainer.init_state(seed)
    spread_codebooks(state.generator, latent_frames(state.generator, torch.from_numpy(x)), seed=seed)
    return state


def close_moments(got: dict, want: dict, what: str) -> None:
    """``{name: (mu, nu)}`` leaf by leaf within 5e-3 of the larger of the leaf's max
    and a hundredth of the phase's max."""
    for i in range(2):
        floor = max(w[i].abs().max().item() for w in want.values()) / 100
        for name, w in want.items():
            err = (got[name][i] - w[i]).abs().max().item()
            assert err <= 5e-3 * max(w[i].abs().max().item(), floor) + 1e-30, (what, name, i, err)


def moments(opt, module):
    st = opt.state_dict()["state"]
    return {n: (st[i]["exp_avg"], st[i]["exp_avg_sq"]) for i, (n, _) in enumerate(module.named_parameters())}


def check_step(state, metrics, jstate, jmetrics, lr):
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    for module, opt, jparams, jopt, to_port in (
            (state.generator, state.g_opt, jstate.g_params, jstate.g_opt_state, hificodec_params_from_jax),
            (state.discriminators, state.d_opt, jstate.d_params, jstate.d_opt_state, discriminators_state_from_jax)):
        want_p, adam = to_port(jparams), jstate_adam(jopt)
        want_mu, want_nu = to_port(adam.mu), to_port(adam.nu)
        close_moments(moments(opt, module), {n: (want_mu[n], want_nu[n]) for n in want_mu}, "vs JAX")
        for name in want_mu:
            got_p = dict(module.named_parameters())[name].detach()
            diff = (got_p - want_p[name]).abs()
            assert diff.max() <= 2 * lr + 1e-6, (name, diff.max().item())
            firm = want_mu[name].abs() >= 1e-3 * want_mu[name].abs().max()
            assert diff[firm].max() <= 1e-6 + 2e-3 * lr, (name, diff[firm].max().item())
    u = discriminators_state_from_jax({}, jstate.d_extra["spectral"])
    sd = state.discriminators.state_dict()
    for name, want in u.items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=1e-6, rtol=0, err_msg=name)


def jstate_adam(opt_state):
    return opt_state.inner_state[0]


@pytest.fixture(scope="module")
def stepped():
    """One step of each package from one converted JAX state, and the codes and
    eval metrics of that state."""
    cfg, jcfg = configs()
    trainer, jtrainer = HiFiCodecTrainer(cfg, device="cpu"), JTrainer(jcfg)
    x = seeded_batch()
    seed_state = start(trainer, x)
    jstate = jax_state_from_port(jtrainer, seed_state)
    state = trainer.init_state(9)
    hificodec_train_state_from_jax(jstate, state)
    _y, _lq, jcodes = jtrainer.model.apply({"params": jstate.g_params}, jnp.asarray(x), training=True)
    jeval = jtrainer.eval_step(jstate, jnp.asarray(x))
    with torch.no_grad():
        codes = state.generator(torch.from_numpy(x), training=True)[2]
    evals = trainer.eval_step(state, x)
    jnew, jmetrics = jtrainer.train_step(jax.tree_util.tree_map(jnp.array, jstate), jnp.asarray(x))
    state, metrics = trainer.train_step(state, x)
    return dict(state=state, metrics=metrics, jstate=jnew, jmetrics=jmetrics, codes=codes, jcodes=jcodes,
                eval=evals, jeval=jeval, lr=cfg.learning_rate, x=x, trainer=trainer, seed_state=seed_state)


def test_train_step_matches_jax(stepped):
    s = stepped
    assert np.array_equal(s["codes"].numpy(), np.asarray(s["jcodes"])) and len(np.unique(s["codes"].numpy())) > 8
    check_step(s["state"], s["metrics"], s["jstate"], s["jmetrics"], s["lr"])
    assert s["state"].step == int(s["jstate"].step) == 1


def test_eval_step_matches_jax(stepped):
    for k in ("val_mel_error", "loss_q"):
        np.testing.assert_allclose(float(stepped["eval"][k]), float(stepped["jeval"][k]), rtol=1e-4, err_msg=k)


def test_packed_towers_follow_the_update(stepped):
    """The step drops the fused stages' packed operands (the card's fused Adam
    leaves version counters as they were), so a no-grad forward after it uses the
    updated weights: it equals the unfused forward under autograd."""
    state, x = stepped["state"], torch.from_numpy(stepped["x"])
    model = state.generator
    assert all(st.packed is None for st in model.encoder._packed + model.generator._packed)
    with torch.no_grad():
        y_fused = model(x)[0]
    y_plain = model(x, training=True)[0].detach()
    assert torch.allclose(y_fused, y_plain, atol=1e-6, rtol=0)
