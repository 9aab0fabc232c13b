"""The HiFi-Codec trainer's modules against the JAX package's, on the CPU.

Spectral norm in both modes (JAX's mutable apply steps ``u``, its plain
apply uses the stored one) with the new ``u`` and the kernel's gradient; the
hificodec-flavor multi-period and multi-scale discriminators (and the
trainer's bundle) on JAX's params; GRVQ's training forward with its
gradients to the input and the codebooks; ``VQVAE.forward(training=True)``
with every parameter's gradient, which holds the narrow stages' unfused
chains under autograd against JAX, and their values against the fused
towers' plain versions; ``MelNpyCropDataset`` bit for bit.

Tolerances: outputs and ``u`` within 1e-5 of their max |value| (atol 1e-6
for ``u``, a unit vector), gradients within 1e-4 of each leaf's max |g|,
codes equal; the data pipeline exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.data.dataset import MelNpyCropDataset as JMelNpyCropDataset
from academicodec_tpu.data.dataset import batch_iterator as jbatch_iterator
from academicodec_tpu.data.wavio import write_wav
from academicodec_tpu.models.hificodec import VQVAE as JVQVAE
from academicodec_tpu.nn.conv import Conv1d as JConv1d
from academicodec_tpu.nn.hifigan import HiFiCodecConfig as JHiFiCodecConfig
from academicodec_tpu.quant.grvq import GroupResidualVQ as JGroupResidualVQ
from academicodec_tpu.train.hificodec import _Discriminators as JDiscriminators
from academicodec_tpu.utils.torch_import import import_hificodec

from chip_smoke import latent_frames, spread_codebooks
from academicodec_tpu_torch.data.dataset import MelNpyCropDataset, batch_iterator
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.nn.conv import Conv1d
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.quant.grvq import GroupResidualVQ
from academicodec_tpu_torch.train.hificodec import Discriminators
from academicodec_tpu_torch.utils.convert import discriminators_state_from_jax, hificodec_params_from_jax

# tests/test_grad_accum.py's tiny HiFi-Codec and discriminators
TINY_MODEL = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                  resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), encoder_base_channels=8,
                  n_code_groups=2, n_codes=16, sampling_rate=16000)
TINY_DISCS = dict(stft_filters=4, stft_n_ffts=(256, 128), mpd_periods=(2, 3), msd_scales=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny models (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, rel, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= rel * scale, (what, np.abs(a - b).max() / scale)


def _cl(a):
    """Channels-last JAX activation -> channels-first."""
    return np.moveaxis(np.asarray(a), -1, 1)


# --------------------------------------------------------------- spectral norm
@pytest.mark.parametrize("advance", [True, False])
def test_spectral_norm_matches_jax(advance):
    x = (np.random.default_rng(0).standard_normal((2, 40, 6)) * 0.5).astype(np.float32)  # [B, T, C]
    jconv = JConv1d(in_channels=6, out_channels=8, kernel_size=5, padding=(2, 2), norm="spectral_norm")
    variables = jconv.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x))
    conv = Conv1d(6, 8, 5, padding=2, norm="spectral_norm")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(np.array(variables["params"]["kernel"]), (2, 1, 0))))
        conv.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
        conv.weight_u.copy_(torch.from_numpy(np.asarray(variables["spectral"]["kernel_u"])))
    u0 = conv.weight_u.clone()

    def jloss(params):
        v = {"params": params, "spectral": variables["spectral"]}
        if advance:
            y, new = jconv.apply(v, jnp.asarray(x), mutable=["spectral"])
            return jnp.sum(y ** 2), (y, new["spectral"]["kernel_u"])
        y = jconv.apply(v, jnp.asarray(x))
        return jnp.sum(y ** 2), (y, v["spectral"]["kernel_u"])

    (_, (jy, ju)), jg = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    y = conv(torch.from_numpy(x).transpose(1, 2), advance=advance)
    y.square().sum().backward()
    _close(y.detach().numpy(), _cl(jy), 1e-5, "y")
    np.testing.assert_allclose(conv.weight_u.numpy(), np.asarray(ju), atol=1e-6, rtol=0)
    assert torch.equal(conv.weight_u, u0) != advance  # u moves only when advanced
    _close(conv.weight.grad.numpy(), np.transpose(np.asarray(jg["kernel"]), (2, 1, 0)), 1e-4, "dW")


# -------------------------------------------------------------- discriminators
@pytest.fixture(scope="module")
def disc_pair():
    x = (np.random.default_rng(1).standard_normal((2, 1603)) * 0.3).astype(np.float32)  # 1603: MPD pads
    jd = JDiscriminators(**TINY_DISCS)
    variables = jax.jit(jd.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    port = Discriminators(**TINY_DISCS)
    port.load_state_dict(discriminators_state_from_jax(variables["params"], variables["spectral"]))
    return jd, variables, port, x


def _check_disc_out(out, ref):
    assert out.keys() == ref.keys()
    for fam in out:
        (logits, fmaps), (jlogits, jfmaps) = out[fam], ref[fam]
        for lg, jl in zip(logits, jlogits, strict=True):
            _close(lg.detach().numpy(), jl, 1e-5, fam)
        for fm, jfm in zip(fmaps, jfmaps, strict=True):
            for a, b in zip(fm, jfm, strict=True):
                _close(a.detach().numpy(), _cl(b), 1e-5, fam)


def test_hificodec_discriminators_match_jax(disc_pair):
    """The trainer's bundle, hificodec-flavor MPD and MSD (scale 0 spectral-normed)
    and the MS-STFT: the D phase's real pass (``u`` advances), then its fake pass
    with the new ``u`` (not advancing)."""
    jd, variables, port, x = disc_pair
    ref, new = jax.jit(lambda v, a: jd.apply(v, a, mutable=["spectral"]))(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x), advance=True)
    _check_disc_out(out, ref)
    new_u = discriminators_state_from_jax({}, new["spectral"])
    assert len(new_u) == 8  # 7 convs + conv_post of scale 0
    sd = port.state_dict()
    for name, u in new_u.items():
        np.testing.assert_allclose(sd[name].numpy(), u.numpy(), atol=1e-6, rtol=0, err_msg=name)
    x2 = x[::-1].copy()
    ref2 = jax.jit(jd.apply)({"params": variables["params"], **new}, jnp.asarray(x2))
    with torch.no_grad():
        out2 = port(torch.from_numpy(x2))
    _check_disc_out(out2, ref2)
    for name, u in new_u.items():  # not advanced again
        np.testing.assert_allclose(sd[name].numpy(), u.numpy(), atol=1e-6, rtol=0, err_msg=name)


# ------------------------------------------------------------------------ GRVQ
def test_grvq_training_forward_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    dim, n_codes, G = 16, 32, 2
    x = (rng.standard_normal((2, 20, dim)) * 0.5).astype(np.float32)
    cb = (rng.standard_normal((2, G, n_codes, dim // G)) * 0.4).astype(np.float32)
    w = rng.standard_normal((2, 20, dim)).astype(np.float32)
    jq = JGroupResidualVQ(dim=dim, n_codes=n_codes, n_groups=G, n_residual=2)

    def jloss(cbs, xin):
        q, loss, codes = jq.apply({"params": {"codebooks": cbs}}, xin, training=True)
        return jnp.sum(q * w) + 3.0 * loss, (q, loss, codes)

    (_, (jqo, jl, jcodes)), (jg_cb, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cb), jnp.asarray(x))
    q = GroupResidualVQ(dim=dim, n_codes=n_codes, n_groups=G, n_residual=2)
    with torch.no_grad():
        q.codebooks.copy_(torch.from_numpy(cb))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, loss, codes = q(xt, training=True)
    ((out * torch.from_numpy(w)).sum() + 3.0 * loss).backward()
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert len(np.unique(codes.numpy())) > 8
    _close(out.detach().numpy(), jqo, 1e-5, "quantized")
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _close(xt.grad.numpy(), jg_x, 1e-5, "dx")
    _close(q.codebooks.grad.numpy(), jg_cb, 1e-5, "dcodebooks")
    assert torch.equal(codes, q.encode(torch.from_numpy(x)))


# ----------------------------------------------------------------------- VQVAE
@pytest.fixture(scope="module")
def vqvae_pair():
    cfg = HiFiCodecConfig(**TINY_MODEL)
    model = VQVAE(cfg, device="cpu", seed=4)
    x = (np.random.default_rng(5).standard_normal((2, 512)) * 0.3).astype(np.float32)
    # codebooks over the encoder's latents, so that codes spread
    spread_codebooks(model, latent_frames(model, torch.from_numpy(x)), seed=6)
    jvars = jax.tree_util.tree_map(jnp.asarray, import_hificodec(
        {k: {n: t.numpy() for n, t in v.items()} for k, v in model.reference_state_dict().items()}))
    return JVQVAE(config=JHiFiCodecConfig(**TINY_MODEL)), jvars, model, x


def test_vqvae_training_forward_and_gradients_match_jax(vqvae_pair):
    """Every stage under autograd, the narrow ones (<= 64 channels: all of this
    model's) on their unfused chains: output, loss_q, codes and each
    parameter's gradient against JAX's unfused trainer forward."""
    jm, jvars, model, x = vqvae_pair
    w = np.random.default_rng(7).standard_normal((2, 512)).astype(np.float32)

    def jloss(params):
        y, lq, codes = jm.apply({"params": params}, jnp.asarray(x), training=True)
        return jnp.sum(y * w) + 10.0 * lq, (y, lq, codes)

    (_, (jy, jlq, jcodes)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jvars["params"])
    model.zero_grad(set_to_none=True)
    y, lq, codes = model(torch.from_numpy(x), training=True)
    ((y * torch.from_numpy(w)).sum() + 10.0 * lq).backward()
    assert np.array_equal(codes.numpy(), np.asarray(jcodes)) and len(np.unique(codes.numpy())) > 8
    _close(y.detach().numpy(), jy, 1e-5, "y")
    np.testing.assert_allclose(lq.item(), float(jlq), rtol=1e-5)
    grads = hificodec_params_from_jax(jg)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), grads[name].numpy(), 1e-4, name)


def test_towers_under_autograd_equal_the_fused_plain_path(vqvae_pair):
    """Under autograd the narrow stages run unfused; without a gradient they take
    ``resblock_tower(_gn)``'s plain versions through the packed operands: the
    same values."""
    _jm, _jvars, model, x = vqvae_pair
    xt = torch.from_numpy(x)
    y_grad, lq_grad, codes_grad = model(xt, training=True)
    assert y_grad.requires_grad
    with torch.no_grad():
        y_fused, lq_fused, codes_fused = model(xt)
    assert all(st.packed is not None for st in model.encoder._packed + model.generator._packed)
    assert torch.equal(codes_grad, codes_fused)
    _close(y_grad.detach().numpy(), y_fused.numpy(), 1e-5, "y")
    np.testing.assert_allclose(lq_grad.item(), lq_fused.item(), rtol=1e-6)


# ------------------------------------------------------------------------ data
@pytest.fixture(scope="module")
def mel_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("melnpy")
    rng = np.random.default_rng(8)
    wavs, mels = root / "wavs", root / "mels"
    wavs.mkdir()
    mels.mkdir()
    # (samples, mel frames, leading batch dim): long, a short wav, a short mel, 3-D
    for i, (n, frames, batched) in enumerate([(5000, 40, False), (900, 12, False), (4000, 5, False),
                                              (3000, 30, True)]):
        write_wav(str(wavs / f"f{i}.wav"), (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
        mel = rng.standard_normal((8, frames)).astype(np.float32)
        np.save(mels / f"f{i}.npy", mel[None] if batched else mel)
    return str(wavs), str(mels)


def test_mel_npy_crop_dataset_is_bit_exact_with_jax(mel_corpus):
    wavs, mels = mel_corpus
    kw = dict(hop_size=100, base_mels_path=mels, sample_rate=16000, seed=11)
    port, ref = MelNpyCropDataset(wavs, 1000, **kw), JMelNpyCropDataset(wavs, 1000, **kw)
    assert port.files == ref.files and port.frames_per_seg == ref.frames_per_seg == 10
    for epoch in range(3):
        for item in range(len(port)):
            (w, m), (jw, jm) = port.sample(item, epoch=epoch, item=item + 1), ref.sample(item, epoch=epoch,
                                                                                      item=item + 1)
            assert np.array_equal(w, jw) and np.array_equal(m, jm) and w.dtype == jw.dtype == np.float32
    got = list(batch_iterator(port, 2, seed=3, epochs=2))
    want = list(jbatch_iterator(ref, 2, seed=3, epochs=2))
    assert len(got) == len(want) == 4
    for (w, m), (jw, jm) in zip(got, want):
        assert w.shape == (2, 1000) and m.shape == (2, 8, 10)
        assert np.array_equal(w, jw) and np.array_equal(m, jm)
