"""The port's discriminators against the JAX package's, on JAX's params, on the CPU.

The bundle of the Encodec/SoundStream trainer (MS-STFT, MPD and MSD of the
soundstream flavor) at the reference topology with narrower STFT filters,
and at the tiny test config: JAX's params are carried across with
``utils/convert.discriminators_state_from_jax`` (Conv2d HWIO -> OIHW, weight
norm's g/v), one seeded wav goes through both, and every logits tensor and
feature map (channels-last in JAX) agrees within 1e-5 of its max |value|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.train.encodec import _Discriminators as JDiscriminators

from academicodec_tpu_torch.nn import discriminators as D
from academicodec_tpu_torch.train.encodec import Discriminators
from academicodec_tpu_torch.utils.convert import discriminators_state_from_jax

CONFIGS = {
    "reference": dict(stft_filters=8, stft_n_ffts=(1024, 2048, 512, 256, 128), mpd_periods=(2, 3, 5, 7, 11),
                      msd_scales=3),
    "tiny": dict(stft_filters=8, stft_n_ffts=(256,), mpd_periods=(2, 3), msd_scales=1),
}


def _to_channels_first(a: np.ndarray) -> np.ndarray:
    return np.moveaxis(a, -1, 1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_discriminators_match_jax(name):
    cfg = CONFIGS[name]
    x = (np.random.default_rng(0).standard_normal((2, 4003)) * 0.1).astype(np.float32)  # 4003: MPD pads
    jd = JDiscriminators(**cfg)
    variables = jax.jit(jd.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    ref = jax.jit(jd.apply)(variables, jnp.asarray(x))
    port = Discriminators(**cfg)
    port.load_state_dict(discriminators_state_from_jax(variables["params"]))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.keys() == ref.keys()
    for fam in out:
        (logits, fmaps), (jlogits, jfmaps) = out[fam], ref[fam]
        assert len(logits) == len(jlogits) and len(fmaps) == len(jfmaps)
        for lg, jl in zip(logits, jlogits):
            jl = np.asarray(jl)
            np.testing.assert_allclose(lg.numpy(), jl, atol=1e-5 * np.abs(jl).max(), rtol=0, err_msg=fam)
        for fm, jfm in zip(fmaps, jfmaps):
            assert len(fm) == len(jfm)
            for a, b in zip(fm, jfm):
                b = _to_channels_first(np.asarray(b))
                np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), rtol=0, err_msg=fam)


def test_discriminator_gradients_reach_weight_norm():
    """``g`` and ``v`` of the STFT discriminator's weight-normed convs get gradients."""
    disc = D.STFTDiscriminator(filters=4, n_fft=128, hop_length=32, win_length=128)
    D.reset_parameters(disc, torch.Generator().manual_seed(0))
    x = torch.randn(2, 1000, generator=torch.Generator().manual_seed(1))
    logits, fmap = disc(x)
    (logits.square().mean() + sum(f.abs().mean() for f in fmap)).backward()
    conv = disc.convs[1]
    assert conv.norm == "weight_norm"
    for p in (conv.weight_g, conv.weight_v, disc.convs[0].weight):
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0


def test_hificodec_flavor_raises():
    """The hificodec flavor builds (its parity with JAX: tests/test_torch_train_hifi.py);
    an unknown flavor raises."""
    mpd, msd = D.MultiPeriodDiscriminator("hificodec", periods=(2,)), D.MultiScaleDiscriminator("hificodec", 2)
    assert [c.weight_v.shape[0] for c in mpd.discriminators[0].convs] == [32, 128, 512, 1024, 1024]
    assert [d.convs[0].norm for d in msd.discriminators] == ["spectral_norm", "weight_norm"]
    with pytest.raises(ValueError):
        D.MultiScaleDiscriminator("nope")
    with pytest.raises(ValueError):
        D.MultiPeriodDiscriminator("nope")
