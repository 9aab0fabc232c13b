"""The port's token-LM trainer against the JAX trainer, and ``cli/train_lm.py``, on the CPU.

One JAX ``LMTrainState`` (JAX's init) is carried to the port with
``utils/convert.lm_train_state_from_jax``; both take one step on the same
seeded codes. Tolerances: the loss rtol 1e-5; each leaf of Adam's moments
within 1e-3 of its max; parameters atol 1e-6 + 1e-3 ``lr`` where JAX's
gradient is at least 1e-3 of its leaf's max, within ``2 lr`` everywhere
(Adam's first update is about ``lr x sign(g)``). The learning-rate schedule
equals optax's ``warmup_cosine_decay_schedule`` (rtol 1e-5: optax evaluates it in f32) at every count
from 0 to past ``decay_steps``. The CLI trains on a SoundStream ``.pth``
and on a ``cli/train_hificodec.py`` state, and ``cli/compress.py --lm`` /
``cli/extract_tokens.py --lm`` code with the result: every blob decodes to
the raw blob's tokens.
"""

import io
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.train.lm import LMTrainConfig as JConfig
from academicodec_tpu.train.lm import LMTrainer as JTrainer

from academicodec_tpu_torch.cli import compress as compress_cli
from academicodec_tpu_torch.cli import train_lm
from academicodec_tpu_torch.codec.binary import read_ecdc_header
from academicodec_tpu_torch.codec.compress import decompress_tokens
from academicodec_tpu_torch.data.wavio import write_wav
from academicodec_tpu_torch.models.lm import load_lm
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.train.lm import LMTrainConfig, LMTrainer
from academicodec_tpu_torch.utils.convert import lm_state_from_jax, lm_train_state_from_jax
from tests.test_torch_lm import SS_FLAGS, SS_KW
from tests.test_torch_train_hifi import one_torch_thread  # noqa: F401 (autouse)

LM = dict(n_q=3, bins=32, dim=32, num_heads=4, num_layers=2, past_context=6)


def test_lm_train_step_matches_jax():
    codes = np.random.default_rng(0).integers(0, LM["bins"], (2, 10, LM["n_q"])).astype(np.int32)
    jtrainer = JTrainer(JConfig(**LM))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jnp.asarray(codes))
    trainer = LMTrainer(LMTrainConfig(**LM), device="cpu")
    state = trainer.init_state(5)
    lm_train_state_from_jax(jstate, state)
    jnew, jm = jtrainer.train_step(jstate, jnp.asarray(codes))
    state, m = trainer.train_step(state, codes)
    for k in ("ce_loss", "bits_per_token"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jnew.step) == 1
    want_p, adam = lm_state_from_jax(jnew.params), jnew.opt_state[0]
    want_mu, want_nu = lm_state_from_jax(adam.mu), lm_state_from_jax(adam.nu)
    st = state.opt.state_dict()["state"]
    lr = LM_LR = trainer.cfg.lr
    for i, (name, p) in enumerate(state.lm.named_parameters()):
        for got, want in ((st[i]["exp_avg"], want_mu[name]), (st[i]["exp_avg_sq"], want_nu[name])):
            assert (got - want).abs().max() <= 1e-3 * want.abs().max() + 1e-30, name
        diff = (p.detach() - want_p[name]).abs()
        firm = want_mu[name].abs() >= 1e-3 * want_mu[name].abs().max()
        assert diff.max() <= 2 * lr + 1e-6 and diff[firm].max() <= 1e-6 + 1e-3 * LM_LR, name


@pytest.mark.parametrize("decay_steps,warmup_steps", [(100, 100), (1000, 30), (7, 100), (50, 0)])
def test_learning_rate_schedule_matches_optax(decay_steps, warmup_steps):
    trainer = LMTrainer(LMTrainConfig(**LM, decay_steps=decay_steps, warmup_steps=warmup_steps), device="cpu")
    lr = trainer.cfg.lr
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, min(warmup_steps, decay_steps // 10), decay_steps, 0.05 * lr)
    for count in range(decay_steps + 3):
        np.testing.assert_allclose(trainer.learning_rate(count), float(sched(count)), rtol=1e-5, atol=1e-12)
    assert LMTrainer(LMTrainConfig(**LM), device="cpu").learning_rate(123) == lr


def test_train_lm_cli_then_compress_with_the_lm(tmp_path):
    """``cli.train_lm --family encodec`` on a SoundStream ``.pth`` (and its own
    meta: family, the frames of a crop), then ``cli.compress --lm`` with its
    LM: each file's blob decodes to the raw blob's tokens, and the LM codes
    those tokens and decodes them back exactly."""
    from academicodec_tpu_torch.codec.lm_compress import compress_tokens_with_lm, decompress_tokens_with_lm

    model = SoundStream(**SS_KW, device="cpu", seed=1)
    torch.save(model.state_dict(), tmp_path / "ss.pth")
    (tmp_path / "in").mkdir()
    for i in range(3):
        write_wav(str(tmp_path / "in" / f"w{i}.wav"),
                  (np.random.default_rng(30 + i).standard_normal(4000) * 0.1).astype(np.float32), 16000)
    codec_flags = [f for f in SS_FLAGS if f]
    train_lm.main(["--train_data_path", str(tmp_path / "in"), "--resume_path", str(tmp_path / "ss.pth"),
                   *codec_flags, "--lm_dim", "16", "--lm_heads", "2", "--lm_layers", "1", "--steps", "3",
                   "--batch_size", "2", "--segment_seconds", "0.2", "--checkpoint_interval", "2",
                   "--cosine_decay", "--path", str(tmp_path / "lm")])
    cfg = json.load(open(tmp_path / "lm" / "lm_config.json"))
    assert cfg["family"] == "encodec" and cfg["trained_frames"] == 10 and cfg["n_q"] == model.n_q_for_bandwidth(2)
    assert sorted(f for f in os.listdir(tmp_path / "lm") if f.startswith("lm_")) == [
        "lm_00000002.pt", "lm_00000003.pt", "lm_config.json"]
    lm, _meta = load_lm(str(tmp_path / "lm"), device="cpu")
    flags = ["--input", str(tmp_path / "in"), "--resume_path", str(tmp_path / "ss.pth"), "--ecdc", *SS_FLAGS]
    compress_cli.main(flags + ["--output", str(tmp_path / "raw")])
    compress_cli.main(flags + ["--output", str(tmp_path / "lmout"), "--lm", str(tmp_path / "lm")])
    for i in range(3):
        raw = (tmp_path / "raw" / f"w{i}.ecdc").read_bytes()
        blob = (tmp_path / "lmout" / f"w{i}.ecdc").read_bytes()
        codes = decompress_tokens(raw)[0]
        np.testing.assert_array_equal(decompress_tokens(blob, lm=lm)[0], codes)
        assert read_ecdc_header(io.BytesIO(blob)).get("lm", False) in (True, False)
        np.testing.assert_array_equal(decompress_tokens_with_lm(lm, compress_tokens_with_lm(lm, codes))[0], codes)


def test_chip_smoke_train_lm_rehearsal():
    """``chip_smoke.phase_train_lm`` at a tiny width on the CPU: no launches, the
    loss falls on its batch, the CLI's LM codes and decodes back exactly."""
    import chip_smoke

    r = chip_smoke.phase_train_lm("cpu", batch=2, seconds=0.5, steps=3, preset="encodec_16k_320d", cli_files=2,
                                  cli_steps=2, lm_width=dict(dim=16, num_heads=2, num_layers=1, past_context=8),
                                  n_filters=4, dimension=32)
    assert r["launches_step"] == {"rvq_encode": 0, "lstm2": 0}
    assert r["codes_shape"] == [2, 25, 24] and r["losses_last"]["ce_loss"] < r["losses_first"]["ce_loss"]
    assert r["cli"]["cli_blob_decodes"] and r["cli"]["lm_blob_decodes"]
