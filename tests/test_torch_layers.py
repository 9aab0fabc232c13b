"""The port's padding math, streaming convs and SEANet towers against the JAX package.

Inputs come from numpy seeds; the same arrays and the same weights (carried
across by ``utils/convert``) go through both packages on the CPU, in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.nn.conv import SConv1d as JSConv1d
from academicodec_tpu.nn.conv import SConvTranspose1d as JSConvTranspose1d
from academicodec_tpu.nn.seanet import SEANetDecoder as JSEANetDecoder
from academicodec_tpu.nn.seanet import SEANetEncoder as JSEANetEncoder
from academicodec_tpu.ops import padding as jpad

from academicodec_tpu_torch.nn.conv import SConv1d, SConvTranspose1d
from academicodec_tpu_torch.nn.seanet import SEANetDecoder, SEANetEncoder
from academicodec_tpu_torch.ops import padding as tpad
from academicodec_tpu_torch.utils.convert import conv_state_from_jax, seanet_state_from_jax

RATIO_SETS = [(8, 5, 4, 2), (6, 5, 4, 2), (2, 2, 2, 4)]


@pytest.mark.parametrize("length", [7, 24000, 16000, 12345, 101])
@pytest.mark.parametrize("k,s", [(7, 1), (16, 8), (10, 5), (8, 4), (4, 2), (3, 1)])
def test_extra_padding_matches_jax(length, k, s):
    padding_total = (k - 1) - (s - 1)
    extra = tpad.get_extra_padding_for_conv1d(length, k, s, padding_total)
    assert extra == jpad.get_extra_padding_for_conv1d(length, k, s, padding_total)
    assert (length + padding_total + extra - k) % s == 0


@pytest.mark.parametrize("ratios", RATIO_SETS)
@pytest.mark.parametrize("length", [24000, 16000, 8192, 12001])
def test_downsample_frame_count_is_ceil(ratios, length):
    t = length
    for r in reversed(ratios):
        k, s = 2 * r, r
        t = (t + (k - s) + tpad.get_extra_padding_for_conv1d(t, k, s, k - s) - k) // s + 1
    assert t == -(-length // int(np.prod(ratios)))


@pytest.mark.parametrize("mode", ["reflect", "zero"])
@pytest.mark.parametrize("length,pads", [(3, (5, 5)), (3, (0, 4)), (10, (2, 7)), (4, (6, 0)), (12, (3, 3))])
def test_pad1d_matches_jax(mode, length, pads):
    """Includes reflect pads wider than the input (the zero-extension guard)."""
    x = np.random.default_rng(length).standard_normal((2, 3, length)).astype(np.float32)
    y = tpad.pad1d(torch.from_numpy(x), pads, mode=mode).numpy()
    ref = np.asarray(jpad.pad1d(jnp.asarray(x.transpose(0, 2, 1)), pads, mode=mode))
    np.testing.assert_array_equal(y, ref.transpose(0, 2, 1))


def test_unpad1d():
    y = tpad.unpad1d(torch.arange(10.0).reshape(1, 1, 10), (2, 3))
    assert y.shape == (1, 1, 5)
    assert y[0, 0].tolist() == [2, 3, 4, 5, 6]
    with pytest.raises(ValueError):
        tpad.unpad1d(torch.zeros(1, 1, 4), (3, 2))


def _jax_apply(module, x_btc, seed=0):
    x = jnp.asarray(x_btc)
    variables = module.init(jax.random.PRNGKey(seed), x)
    return variables["params"], np.asarray(jax.jit(module.apply)(variables, x))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("k,s,d,length", [(7, 1, 1, 4), (4, 2, 1, 9), (3, 1, 2, 3), (10, 5, 1, 23)])
def test_sconv1d_matches_jax(causal, k, s, d, length):
    """Reflect padding wider than the input for the short lengths."""
    cin, cout = 3, 5
    x = np.random.default_rng(k * length).standard_normal((2, length, cin)).astype(np.float32)
    params, ref = _jax_apply(
        JSConv1d(in_channels=cin, out_channels=cout, kernel_size=k, stride=s, dilation=d, causal=causal), x
    )
    mod = SConv1d(cin, cout, k, stride=s, dilation=d, causal=causal)
    mod.conv.conv.load_state_dict(conv_state_from_jax(params["conv"], transposed=False))
    with torch.no_grad():
        y = mod(torch.from_numpy(x.transpose(0, 2, 1))).numpy()
    np.testing.assert_allclose(y, ref.transpose(0, 2, 1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "causal,trim,k,s", [(False, 1.0, 8, 4), (True, 1.0, 8, 4), (True, 0.5, 10, 5), (False, 1.0, 4, 2)]
)
def test_sconvtranspose1d_matches_jax(causal, trim, k, s):
    cin, cout, length = 6, 3, 11
    x = np.random.default_rng(k).standard_normal((2, length, cin)).astype(np.float32)
    params, ref = _jax_apply(
        JSConvTranspose1d(in_channels=cin, out_channels=cout, kernel_size=k, stride=s,
                          causal=causal, trim_right_ratio=trim), x
    )
    mod = SConvTranspose1d(cin, cout, k, stride=s, causal=causal, trim_right_ratio=trim)
    mod.convtr.convtr.load_state_dict(conv_state_from_jax(params["convtr"], transposed=True))
    with torch.no_grad():
        y = mod(torch.from_numpy(x.transpose(0, 2, 1))).numpy()
    assert y.shape == (2, cout, length * s)
    np.testing.assert_allclose(y, ref.transpose(0, 2, 1), atol=1e-5, rtol=1e-5)


TINY = dict(n_filters=4, dimension=32, ratios=(6, 5, 4, 2))


def test_seanet_encoder_matches_jax():
    x = (np.random.default_rng(0).standard_normal((2, 4800, 1)) * 0.1).astype(np.float32)
    params, ref = _jax_apply(JSEANetEncoder(**TINY), x)
    enc = SEANetEncoder(**TINY)
    enc.load_state_dict(seanet_state_from_jax(params))
    with torch.no_grad():
        y = enc(torch.from_numpy(x.transpose(0, 2, 1))).numpy()
    assert y.shape == (2, 32, 20)
    np.testing.assert_allclose(y, ref.transpose(0, 2, 1), atol=1e-5, rtol=0)


def test_seanet_decoder_matches_jax():
    z = np.random.default_rng(1).standard_normal((2, 20, 32)).astype(np.float32)
    params, ref = _jax_apply(JSEANetDecoder(**TINY), z)
    dec = SEANetDecoder(**TINY)
    dec.load_state_dict(seanet_state_from_jax(params))
    with torch.no_grad():
        y = dec(torch.from_numpy(z.transpose(0, 2, 1))).numpy()
    assert y.shape == (2, 1, 4800)
    np.testing.assert_allclose(y, ref.transpose(0, 2, 1), atol=1e-5, rtol=0)
