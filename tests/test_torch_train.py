"""The port's Encodec/SoundStream trainer against the JAX trainer, on the CPU.

One state is made by the port (``EncodecTrainer.init_state``), carried to
JAX (``torch_import.import_soundstream`` and the inverse of the
discriminator mapping below), and carried back with
``utils/convert.train_state_from_jax``, so both packages start from one
converted JAX state. The port's steps are given JAX's draws: ``n_q`` from
JAX's bandwidth keys and, per layer, the rows ``sample_vectors`` takes
from the quantizer's ``make_rng('rvq')`` key (:func:`jax_rows`).

Shapes are tests/test_train.py's ``_tiny_encodec_cfg`` and its ``[2, 3200]``
batch. Tolerances: the quantizer forward within 1e-5 (codes equal); G-phase
losses rtol 1e-4 and each gradient leaf within 1e-3 of its max |g|; the
optimizer's update atol 1e-7 against optax's; a whole step's losses rtol
1e-4 and codebook state atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.quant.core_vq import ResidualVQ as JResidualVQ
from academicodec_tpu.train.encodec import EncodecTrainConfig as JConfig
from academicodec_tpu.train.encodec import EncodecTrainer as JTrainer
from academicodec_tpu.train.state import GANTrainState as JState
from academicodec_tpu.train.state import set_learning_rate as jset_lr
from academicodec_tpu.utils.torch_import import import_soundstream

from academicodec_tpu_torch.quant.core_vq import THRESHOLD_EMA_DEAD_CODE, ResidualVQ
from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer, ForwardDraws, StepDraws
from academicodec_tpu_torch.utils.convert import soundstream_params_from_jax, train_state_from_jax

TINY = dict(
    sr=16000, ratios=(8, 5, 4, 2), target_bandwidths=(1, 2, 4), n_filters=4, dimension=32, bins=64,
    discriminator_iter_start=1, mel_scale_powers=(6, 7), stft_filters=8, stft_n_ffts=(256,),
    mpd_periods=(2, 3), msd_scales=1,
)
BATCH, T = 2, 3200
FRAMES = BATCH * T // 320


def seeded_batch(seed=0, shape=(BATCH, T)):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# JAX draws and states
def sample_index(key, n: int, num: int) -> np.ndarray:
    """The rows JAX ``sample_vectors(key, samples, num)`` takes from ``n`` samples."""
    if n >= num:
        return np.asarray(jax.random.permutation(key, n)[:num])
    return np.asarray(jax.random.randint(key, (num,), 0, n))


def jax_rows(module, variables, key, n: int, path=("quantizer", "vq")) -> torch.Tensor:
    """``[n_q_max, bins]``: each layer's rows in a JAX training forward keyed by ``key``."""
    def rng_of(m):
        for name in path:
            m = getattr(m, name)
        return m.make_rng("rvq")

    vq_key = module.apply(variables, method=rng_of, rngs={"rvq": key})
    cb = variables["codebook"]
    for name in path:
        cb = cb[name]
    n_q_max, bins = cb["embed"].shape[:2]
    keys = jax.random.split(vq_key, n_q_max)
    return torch.from_numpy(np.stack([sample_index(k, n, bins) for k in keys]))


def jax_step_draws(jtrainer, jstate, accum: int = 1, frames: int = FRAMES) -> StepDraws:
    """The draws of JAX's ``train_step`` from ``jstate.rng`` for a batch of
    ``frames`` latent frames (JAX train/encodec.py:262, 333)."""
    _, k_bw1, k_bw2, k_rvq1, k_rvq2 = jax.random.split(jstate.rng, 5)
    variables = {"params": jstate.g_params, **jstate.g_extra}
    n = frames // accum

    def rows(key):
        keys = [key] if accum == 1 else list(jax.random.split(key, accum))
        return [jax_rows(jtrainer.model, variables, k, n) for k in keys]

    return StepDraws(ForwardDraws(int(jtrainer.model.sample_n_q(k_bw1)), rows(k_rvq1)),
                     ForwardDraws(int(jtrainer.model.sample_n_q(k_bw2)), rows(k_rvq2)))


def discs_to_jax(discs) -> dict:
    """The port's discriminator state dict as JAX params (the inverse of
    ``discriminators_state_from_jax``)."""
    names = {"weight": "kernel", "weight_v": "kernel_v", "weight_g": "kernel_g", "bias": "bias"}
    tree: dict = {}
    for key, value in discs.state_dict().items():
        parts = key.split(".")
        path, leaf = [parts[0]], parts[-1]
        i = 1
        while i < len(parts) - 1:
            if i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
                path.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        a = value.numpy()
        if leaf != "bias":
            a = np.transpose(a, (2, 3, 1, 0) if a.ndim == 4 else (2, 1, 0))
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[names[leaf]] = jnp.asarray(a)
    return tree


def jax_state_from_port(jtrainer, state, seed=1) -> JState:
    g_sd = {k: v.numpy() for k, v in state.generator.state_dict().items()}
    g_vars = import_soundstream(g_sd, state.generator.n_q)
    g_vars = jax.tree_util.tree_map(jnp.asarray, g_vars)
    return JState.create(g_vars, {"params": discs_to_jax(state.discriminators)}, jtrainer.g_tx,
                         jtrainer.d_tx, jax.random.PRNGKey(seed))


def port_state_from(jstate, trainer, seed=123):
    state = trainer.init_state(seed)
    train_state_from_jax(jstate, state)
    return state


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny models: the suite's workers share the
    host's cores, and a tiny op's thread pool then costs more than its work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trainers():
    return EncodecTrainer(EncodecTrainConfig(**TINY), device="cpu"), JTrainer(JConfig(**TINY))


@pytest.fixture(scope="module")
def start(trainers):
    """One JAX state made from a seeded port state."""
    trainer, jtrainer = trainers
    return jax_state_from_port(jtrainer, trainer.init_state(0))


def assert_close_tree(port: dict, ref: dict, rel: float):
    assert set(port) == set(ref)
    for k in ref:
        r = ref[k].numpy()
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(port[k].detach().numpy(), r, atol=rel * scale, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
def test_conversion_roundtrip(trainers, start):
    """The converted JAX state loads into another port state as the original port state."""
    trainer, _ = trainers
    ref = trainer.init_state(0)
    state = port_state_from(start, trainer)
    for a, b in ((state.generator, ref.generator), (state.discriminators, ref.discriminators)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert not any(state.generator.quantizer.vq.inited_layers())


@pytest.mark.parametrize("frames", [40, 10])
def test_rvq_training_forward_matches_jax(frames):
    """k-means init, codes, EMA state, expiry and commit of ``ResidualVQ`` from
    an un-inited state, three forwards in turn (n_q 5: k-means of layers 0-4;
    n_q 8: layers 5-7 inited with 0-4 live; n_q 8: one search, dead codes
    replaced), with JAX's rows. ``frames`` 40 x 2 samples take permutation rows,
    10 x 2 (fewer than the 64 bins) uniform ones."""
    n_q_max, dim, bins = 8, 32, 64
    jmod = JResidualVQ(num_quantizers=n_q_max, dim=dim, codebook_size=bins)
    x0 = jnp.zeros((2, frames, dim))
    variables = jmod.init({"params": jax.random.PRNGKey(0)}, x0)
    mod = ResidualVQ(n_q_max, dim, bins)
    mod.init_training_state()
    rng = np.random.default_rng(1)
    for call, (n_q, seed) in enumerate(((5, 10), (8, 11), (8, 12))):
        x = (rng.standard_normal((2, frames, dim)) * (1.0 + call)).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        rows = jax_rows(jmod, variables, key, 2 * frames, path=())
        (jq, jcodes, jloss), upd = jmod.apply(variables, jnp.asarray(x), n_q=n_q, training=True,
                                             mutable=["codebook"], rngs={"rvq": key})
        variables = {**variables, **upd}
        xt = torch.from_numpy(x).requires_grad_(True)
        q, codes, losses = mod(xt, n_q=n_q, training=True, draws=rows)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes)[:n_q])
        assert len(np.unique(codes.numpy())) > 8
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), atol=1e-5)
        np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jloss)[:n_q], atol=1e-5, rtol=1e-5)
        cb = variables["codebook"]
        for name in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_allclose(getattr(mod, name).numpy(), np.asarray(cb[name]), atol=1e-5, rtol=1e-5,
                                       err_msg=f"call {call}: {name}")
        np.testing.assert_array_equal(mod.inited.numpy(), np.asarray(cb["inited"]))
        assert mod.inited_layers() == [bool(v) for v in np.asarray(cb["inited"])]
        (q.sum() + losses.sum()).backward()  # the STE passes the gradient to x
        assert torch.isfinite(xt.grad).all() and xt.grad.abs().sum() > 0
    # the third call replaced dead codes (cluster_size reset to the threshold)
    assert (mod.cluster_size == THRESHOLD_EMA_DEAD_CODE).any()


def test_g_phase_loss_and_grads_match_jax(trainers, start):
    """One G phase, from one converted state with JAX's draws, against JAX's
    ``value_and_grad`` of the same loss (JAX train/encodec.py:266-276)."""
    trainer, jtrainer = trainers
    jstate = start
    draws = jax_step_draws(jtrainer, jstate)
    x = seeded_batch()
    _, _, _, k_rvq1, _ = jax.random.split(jstate.rng, 5)

    def g_loss_fn(g_params):
        g_x, commit, new_extra = jtrainer._gen_forward(g_params, jstate.g_extra, jnp.asarray(x), draws.g.n_q, k_rvq1)
        out_real = jtrainer._disc_all(jstate.d_params, jnp.asarray(x))
        out_gen = jtrainer._disc_all(jstate.d_params, g_x)
        total, metrics = jtrainer._g_loss(out_real, out_gen, jnp.asarray(x), g_x, commit, jstate.step)
        return total, (new_extra, metrics)

    (jtotal, (jextra, jmetrics)), jgrads = jax.jit(jax.value_and_grad(g_loss_fn, has_aux=True))(jstate.g_params)
    state = port_state_from(jstate, trainer)
    state, metrics = trainer.train_step(state, x, draws=draws)
    np.testing.assert_allclose(float(metrics["loss_g"]), float(jtotal), rtol=1e-4)
    for name in ("rec_loss", "adv_g_loss", "feat_loss", "commit_loss"):
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=1e-4, atol=1e-7, err_msg=name)
    grads = {n: p.grad for n, p in state.generator.named_parameters()}
    assert_close_tree(grads, soundstream_params_from_jax(jgrads), rel=1e-3)


def test_optimizer_matches_optax(trainers, start):
    """AdamW fed JAX's gradients: two updates against optax's ``adamw`` (weight
    decay 1e-4 on every leaf, eps 1e-8), the second from a converted optax state."""
    trainer, jtrainer = trainers
    jstate = start
    rng = np.random.default_rng(3)
    state = port_state_from(jstate, trainer)
    params = jstate.g_params
    opt_state = jstate.g_opt_state
    for it in range(2):
        jgrads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = jtrainer.g_tx.update(jgrads, opt_state, params)
        new_params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        if it == 1:  # the port continues from optax's state, converted
            jcarry = jstate.replace(g_params=params, g_opt_state=opt_state_prev)
            train_state_from_jax(jcarry, state)
        port_grads = soundstream_params_from_jax(jgrads)
        before = {n: p.detach().clone() for n, p in state.generator.named_parameters()}
        for n, p in state.generator.named_parameters():
            p.grad = port_grads[n].clone()
        state.g_opt.step()
        ref_updates = soundstream_params_from_jax(updates)
        for n, p in state.generator.named_parameters():
            np.testing.assert_allclose((p.detach() - before[n]).numpy(), ref_updates[n].numpy(), atol=1e-7,
                                       rtol=0, err_msg=f"update {it}: {n}")
        opt_state_prev, params = opt_state, new_params
    assert int(state.g_opt.state_dict()["state"][0]["step"]) == 2


def test_train_step_matches_jax(trainers, start):
    """Two whole steps (the first inits every active layer by k-means, the second
    searches them in one call), each from JAX's state converted anew and the
    second at lr 0 (tests/test_torch_train_accum.py says why), against JAX's
    jitted ``train_step``: losses, and the codebook state after each."""
    trainer, jtrainer = trainers
    jstate = jax.tree_util.tree_map(jnp.copy, start)
    state = port_state_from(jstate, trainer)
    for step in range(2):
        x = seeded_batch(step)
        if step:  # lr 0: the D phase regenerates from the weights both packages hold
            jstate = jstate.replace(g_opt_state=jset_lr(jstate.g_opt_state, 0.0),
                                    d_opt_state=jset_lr(jstate.d_opt_state, 0.0))
        train_state_from_jax(jstate, state)  # each step from one converted state
        draws = jax_step_draws(jtrainer, jstate)
        jstate, jmetrics = jtrainer.train_step(jstate, jnp.asarray(x))
        state, metrics = trainer.train_step(state, x, draws=draws)
        assert state.step == int(jstate.step) == step + 1
        for name, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[name]), float(value), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step}: {name}")
        vq = state.generator.quantizer.vq
        cb = jstate.g_extra["codebook"]["quantizer"]["vq"]
        np.testing.assert_array_equal(vq.inited.numpy(), np.asarray(cb["inited"]))
        for name in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_allclose(getattr(vq, name).numpy(), np.asarray(cb[name]), atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {step}: {name}")


def test_mixed_precision_step_keeps_f32_state(trainers):
    """bf16 forwards and backwards: finite losses, and every parameter, Adam moment
    and codebook buffer still f32 after two steps."""
    trainer, _ = trainers
    mp = EncodecTrainer(EncodecTrainConfig(**TINY, mixed_precision=True), device="cpu")
    state = mp.init_state(0)
    for step in range(2):
        state, metrics = mp.train_step(state, seeded_batch(step))
        for name, value in metrics.items():
            assert torch.isfinite(value), name
    vq = state.generator.quantizer.vq
    assert all(vq.inited_layers()[: 1])
    for module, opt in ((state.generator, state.g_opt), (state.discriminators, state.d_opt)):
        assert all(p.dtype == torch.float32 for p in module.parameters())
        for s in opt.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in (vq.embed, vq.embed_avg, vq.cluster_size))
    assert state.generator.dtype == torch.float32
