"""The port's STFT, mel front ends and training losses against the JAX package, on the CPU.

Tolerances: spectra and mels within 1e-5 of their max |value|, filterbanks
and windows within 1e-6 (both are numpy), every loss of ``losses/`` rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from academicodec_tpu.losses import gan as jgan
from academicodec_tpu.losses import mel as jmel
from academicodec_tpu.ops import stft as jstft

from academicodec_tpu_torch.losses import gan, mel
from academicodec_tpu_torch.ops import stft


def _wav(seed=0, shape=(2, 4000)):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def assert_rel(port, ref, rel=1e-5):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("htk,norm", [(True, None), (False, "slaney")])
@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [(24000, 1024, 64, None), (16000, 512, 80, 8000.0)])
def test_mel_filterbank_and_window_match_jax(htk, norm, sr, n_fft, n_mels, fmax):
    ours = stft.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax, htk, norm)
    np.testing.assert_allclose(ours, jstft.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax, htk, norm), atol=1e-6)
    np.testing.assert_allclose(stft.hann_window(n_fft), jstft.hann_window(n_fft), atol=1e-7)
    np.testing.assert_allclose(stft.hann_window(n_fft), torch.hann_window(n_fft).numpy(), atol=1e-6)


@pytest.mark.parametrize("n_fft,hop,win,center,normalized", [
    (1024, 256, 1024, True, False), (512, 128, 256, True, False), (256, 64, 256, False, True),
    (2048, 512, 2048, False, True),
])
def test_stft_matches_jax(n_fft, hop, win, center, normalized):
    x = _wav()
    ours = stft.stft(torch.from_numpy(x), n_fft, hop, win, center=center, normalized=normalized).numpy()
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, win, center=center, normalized=normalized))
    assert_rel(ours.real, ref.real)
    assert_rel(ours.imag, ref.imag)
    ours_p = stft.spectrogram(torch.from_numpy(x), n_fft, hop, win, power=1.0, center=center).numpy()
    assert_rel(ours_p, np.asarray(jstft.spectrogram(jnp.asarray(x), n_fft, hop, win, power=1.0, center=center)))


@pytest.mark.parametrize("s", [64, 512, 2048])
def test_mel_torchaudio_matches_jax(s):
    x = _wav(1)
    kw = dict(n_fft=max(s, 512), hop_length=s // 4, win_length=s, n_mels=64)
    ours = stft.mel_spectrogram_torchaudio(torch.from_numpy(x), 24000, **kw).numpy()
    assert_rel(ours, np.asarray(jstft.mel_spectrogram_torchaudio(jnp.asarray(x), 24000, **kw)))


@pytest.mark.parametrize("n_fft,hop", [(1024, 240), (512, 120), (256, 60)])
def test_mel_hifigan_matches_jax(n_fft, hop):
    x = _wav(2)
    kw = dict(n_fft=n_fft, num_mels=80, sampling_rate=24000, hop_size=hop, win_size=n_fft, fmin=0.0, fmax=None)
    ours = stft.mel_spectrogram_hifigan(torch.from_numpy(x), **kw).numpy()
    assert_rel(ours, np.asarray(jstft.mel_spectrogram_hifigan(jnp.asarray(x), **kw)))


def test_mel_losses_match_jax():
    x, y = _wav(3), _wav(4)
    for powers in ((6, 7, 8, 9, 10, 11), (6, 7, 8, 9, 10)):
        ours = mel.mel_reconstruction_loss(torch.from_numpy(x), torch.from_numpy(y), 24000, scale_powers=powers)
        ref = jmel.mel_reconstruction_loss(jnp.asarray(x), jnp.asarray(y), 24000, scale_powers=powers)
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    kw = dict(n_fft=1024, num_mels=80, sampling_rate=24000, hop_size=240, win_size=1024, fmin=0.0,
              fmax_for_loss=None)
    ours = mel.hifigan_mel_losses(torch.from_numpy(x), torch.from_numpy(y), None, **kw)
    ref = jmel.hifigan_mel_losses(jnp.asarray(x), jnp.asarray(y), None, **kw)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-5)


def _disc_outputs(seed):
    rng = np.random.default_rng(seed)
    logits = [rng.standard_normal((2, n)).astype(np.float32) for n in (30, 17, 5)]
    fmaps = [[rng.standard_normal((2, 4, n)).astype(np.float32) for _ in range(3)] for n in (30, 17, 5)]
    return logits, fmaps


def test_gan_losses_match_jax():
    (lr, fr), (lg, fg) = _disc_outputs(5), _disc_outputs(6)
    t = lambda xs: [torch.from_numpy(a) for a in xs]  # noqa: E731
    tt = lambda xss: [t(xs) for xs in xss]  # noqa: E731
    j = lambda xs: [jnp.asarray(a) for a in xs]  # noqa: E731
    jj = lambda xss: [j(xs) for xs in xss]  # noqa: E731
    pairs = [
        (gan.hinge_adversarial_g_loss(t(lg)), jgan.hinge_adversarial_g_loss(j(lg))),
        (gan.hinge_discriminator_loss(t(lr), t(lg)), jgan.hinge_discriminator_loss(j(lr), j(lg))),
        (gan.relative_feature_loss(tt(fr), tt(fg)), jgan.relative_feature_loss(jj(fr), jj(fg))),
        (gan.absolute_feature_loss(tt(fr), tt(fg)), jgan.absolute_feature_loss(jj(fr), jj(fg))),
        (gan.sim_loss(t(lr), t(lg)), jgan.sim_loss(j(lr), j(lg))),
        (gan.ls_generator_loss(t(lg))[0], jgan.ls_generator_loss(j(lg))[0]),
        (gan.ls_discriminator_loss(t(lr), t(lg))[0], jgan.ls_discriminator_loss(j(lr), j(lg))[0]),
    ]
    for i, (o, r) in enumerate(pairs):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-5, err_msg=str(i))
    for o, r in zip(gan.ls_discriminator_loss(t(lr), t(lg))[1], jgan.ls_discriminator_loss(j(lr), j(lg))[1]):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-5)
    for step in (0, 4, 5, 9):
        assert gan.adopt_weight(2.0, step, 5) == float(jgan.adopt_weight(2.0, step, 5))


def test_mel_loss_is_differentiable():
    x = torch.from_numpy(_wav(7))
    y = torch.from_numpy(_wav(8)).requires_grad_(True)
    mel.mel_reconstruction_loss(x, y, 16000, scale_powers=(6, 7)).backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().sum() > 0
