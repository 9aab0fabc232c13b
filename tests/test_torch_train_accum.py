"""Gradient accumulation of the port's trainer against JAX's ``accum_steps``, on the CPU.

``accum_steps=2`` splits the ``[2, 3200]`` batch into two sequential
microbatches; the codebook EMA sees them in turn and each phase makes one
update from the mean gradient (JAX train/encodec.py:318-424). From one
converted state with JAX's draws (per microbatch), two steps agree with
JAX's jitted step on the losses (rtol 1e-4) and the codebook state (atol
1e-4), and the accumulated G-phase gradient agrees with JAX's (each leaf
within 1e-3 of its max |g|). The codebook state is held on ``embed`` and
on the per-layer totals of ``embed_avg`` and ``cluster_size`` (within the
sum of their 64 codes' elementwise bounds): a microbatch
has 10 latent frames for 64 bins, so k-means seeds and dead-code samples
are drawn with replacement and twin codes appear; a frame the layers before
quantized exactly has a zero residual, equidistant from twin codes, and goes
to the twin each package's matmul rounds nearer (counts 0.01 apart, as
measured). The totals do not depend on which twin took a frame. Each step starts from JAX's state converted
anew, at lr 0: AdamW's update is about ``lr * sign(g)`` for a small ``g``,
so a gradient element near 0 whose sign the two packages' roundings split
moves its weight up to ``2 lr`` apart, and the D phase's regenerate, which
runs on the updated weights, can then part at a near-tie of the codes (seen
here at lr 3e-4: the weights 5.2e-4 apart, one layer-0 code). The update
itself is held against optax in tests/test_torch_train.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from academicodec_tpu.train.encodec import EncodecTrainConfig as JConfig
from academicodec_tpu.train.encodec import EncodecTrainer as JTrainer
from academicodec_tpu.train.state import set_learning_rate as jset_lr

from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer
from academicodec_tpu_torch.utils.convert import train_state_from_jax
from academicodec_tpu_torch.utils.convert import soundstream_params_from_jax
from tests.test_torch_train import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    TINY,
    one_torch_thread,
    assert_close_tree,
    jax_state_from_port,
    jax_step_draws,
    port_state_from,
    seeded_batch,
)


def jax_accum_g_grads(jtrainer, jstate, x, n_q, k_rvq1, k):
    """JAX's accumulated G-phase gradient, from its own pieces as its scan runs
    them (JAX train/encodec.py:345-370): microbatch ``i`` with the codebooks that
    microbatch ``i - 1`` left, the gradients summed and divided by ``k``."""
    def g_loss_fn(g_params, extra, xi, key):
        g_x, commit, new_extra = jtrainer._gen_forward(g_params, extra, xi, n_q, key)
        out_real = jtrainer._disc_all(jstate.d_params, xi)
        out_gen = jtrainer._disc_all(jstate.d_params, g_x)
        total, _ = jtrainer._g_loss(out_real, out_gen, xi, g_x, commit, jstate.step)
        return total, new_extra

    grad_fn = jax.jit(jax.value_and_grad(g_loss_fn, has_aux=True))
    xm = jnp.asarray(x).reshape(k, x.shape[0] // k, x.shape[1])
    extra, acc = jstate.g_extra, None
    for xi, key in zip(xm, jax.random.split(k_rvq1, k)):
        (_, extra), grads = grad_fn(jstate.g_params, extra, xi, key)
        acc = grads if acc is None else jax.tree_util.tree_map(jnp.add, acc, grads)
    return jax.tree_util.tree_map(lambda t: t / k, acc)


def test_accum_steps_matches_jax():
    trainer = EncodecTrainer(EncodecTrainConfig(**TINY, accum_steps=2), device="cpu")
    jtrainer = JTrainer(JConfig(**TINY, accum_steps=2))
    jstate = jax_state_from_port(jtrainer, trainer.init_state(0))
    state = port_state_from(jstate, trainer)
    for step in range(2):
        x = seeded_batch(step)
        jstate = jstate.replace(g_opt_state=jset_lr(jstate.g_opt_state, 0.0),
                                d_opt_state=jset_lr(jstate.d_opt_state, 0.0))
        train_state_from_jax(jstate, state)
        draws = jax_step_draws(jtrainer, jstate, accum=2)
        assert len(draws.g.rows) == len(draws.d.rows) == 2
        if step == 0:  # the first step inits by k-means in microbatch 0
            _, _, _, k_rvq1, _ = jax.random.split(jstate.rng, 5)
            jgrads = jax_accum_g_grads(jtrainer, jstate, x, draws.g.n_q, k_rvq1, 2)
        jstate, jmetrics = jtrainer.train_step(jstate, jnp.asarray(x))
        state, metrics = trainer.train_step(state, x, draws=draws)
        for name, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[name]), float(value), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step}: {name}")
        if step == 0:
            grads = {n: p.grad for n, p in state.generator.named_parameters()}
            assert_close_tree(grads, soundstream_params_from_jax(jgrads), rel=1e-3)
        vq = state.generator.quantizer.vq
        cb = jstate.g_extra["codebook"]["quantizer"]["vq"]
        np.testing.assert_array_equal(vq.inited.numpy(), np.asarray(cb["inited"]))
        np.testing.assert_allclose(vq.embed.numpy(), np.asarray(cb["embed"]), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {step}: embed")
        for name in ("embed_avg", "cluster_size"):
            ours, ref = getattr(vq, name).numpy(), np.asarray(cb[name])
            # twin-invariant: the totals over each layer's codes, within the sum of the
            # 64 codes' elementwise bounds
            ours, ref = ours.sum(axis=1), ref.sum(axis=1)
            np.testing.assert_allclose(ours, ref, atol=64 * 1e-4, rtol=1e-4, err_msg=f"step {step}: {name}")
    assert state.step == 2


def test_accum_steps_rejects_uneven_batch():
    trainer = EncodecTrainer(EncodecTrainConfig(**TINY, accum_steps=3), device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        trainer.train_step(trainer.init_state(0), seeded_batch())
