"""The SEANet layer options in the port against the JAX package, on the CPU.

The post-conv norms ``layer_norm`` and ``time_group_norm`` (``nn/norm.py``,
``nn/conv.py``), SLSTMs of 1 and 3 layers (``nn/lstm.py``: the plain step
loop on the CPU) and ``lstm=0``, each in a tiny SoundStream whose JAX
weights go across with ``utils/convert``, the codebooks spread over the JAX
encoder's latent frames (tests/test_torch_soundstream.py), and a streamed
causal ``layer_norm`` / ``lstm=3`` session. The JAX SoundStream fixes SEANet's
``lstm`` at 2, so :class:`JSoundStreamOptions` passes it through. Contract:
tokens identical, wav within atol 1e-4 / rtol 1e-3, the norms alone within
atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.models.soundstream import SoundStream as JSoundStream
from academicodec_tpu.nn.lstm import SLSTM as JSLSTM
from academicodec_tpu.nn.norm import ConvLayerNorm as JConvLayerNorm
from academicodec_tpu.nn.norm import TimeGroupNorm as JTimeGroupNorm
from academicodec_tpu.nn.seanet import SEANetDecoder as JSEANetDecoder
from academicodec_tpu.nn.seanet import SEANetEncoder as JSEANetEncoder
from academicodec_tpu.quant.vq import ResidualVectorQuantizer as JResidualVectorQuantizer
from academicodec_tpu.streaming import StreamingDecoder as JStreamingDecoder
from academicodec_tpu.streaming import StreamingEncoder as JStreamingEncoder

from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.conv import SConv1d
from academicodec_tpu_torch.nn.lstm import SLSTM
from academicodec_tpu_torch.nn.norm import ConvLayerNorm, TimeGroupNorm
from academicodec_tpu_torch.streaming import StreamingDecoder, StreamingEncoder
from academicodec_tpu_torch.utils.convert import slstm_state_from_jax, soundstream_state_from_jax
from test_torch_soundstream import assert_tokens_follow_the_wav, with_spread_codebooks

# two SEANet stages (hop 8) keep JAX's compiles short; 4 codebooks of 1024 at 80 kbps
KW = dict(n_filters=4, dimension=32, ratios=(4, 2), sample_rate=16000, target_bandwidths=(40, 80))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread keeps parallel
    pytest workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JSoundStreamOptions(JSoundStream):
    """The JAX SoundStream with SEANet's ``lstm`` layer count passed through."""

    lstm: int = 2

    def setup(self):
        common = dict(n_filters=self.n_filters, dimension=self.dimension, ratios=tuple(self.ratios),
                      causal=self.causal, pad_mode=self.pad_mode, norm=self.norm, lstm=self.lstm)
        self.encoder = JSEANetEncoder(**common)
        self.decoder = JSEANetDecoder(**common)
        self.quantizer = JResidualVectorQuantizer(dimension=self.dimension, n_q=self.n_q, bins=self.bins)


def _wav(seed, shape=(2, 480)):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def _models(wav, seed=0, **kw):
    """The JAX model (codebooks spread over its latent frames of ``wav``) and the port's copy."""
    jmodel = JSoundStreamOptions(**KW, **kw)
    rng = jax.random.PRNGKey(seed)
    variables = jax.jit(jmodel.init, static_argnames=("training",))(
        {"params": rng, "rvq": rng}, jnp.zeros((1, wav.shape[-1])), n_q=jmodel.n_q, training=False)
    variables = with_spread_codebooks(jmodel, variables, wav, seed)
    model = SoundStream(**KW, **kw, device="cpu")
    model.load_state_dict(soundstream_state_from_jax(variables))
    return jmodel, variables, model


@pytest.mark.parametrize("name", ["layer_norm", "time_group_norm"])
def test_post_conv_norm_matches_jax(name):
    rng = np.random.default_rng(1)
    C = 12
    x = (rng.standard_normal((2, C, 37)) * 2 + 0.5).astype(np.float32)
    scale, bias = (rng.standard_normal(C).astype(np.float32) for _ in range(2))
    if name == "layer_norm":
        ours, jmod, params = ConvLayerNorm(C), JConvLayerNorm(channels=C), {"ln": {"scale": scale, "bias": bias}}
    else:
        ours, jmod, params = TimeGroupNorm(C), JTimeGroupNorm(channels=C), {"scale": scale, "bias": bias}
    ours.weight.data, ours.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 1)))).transpose(0, 2, 1)
    np.testing.assert_allclose(ours(torch.from_numpy(x)).detach().numpy(), ref, atol=1e-5, rtol=0)


def _jax_roundtrip(m, w):
    codes = m.encode(w)
    return codes, m.decode(codes)


# each norm mode and each SLSTM layer count but 2 (every other test's) once
@pytest.mark.parametrize("norm,lstm", [("layer_norm", 1), ("time_group_norm", 3), ("weight_norm", 0)])
def test_tiny_soundstream_layer_options_match_jax(norm, lstm):
    wav = _wav(3)
    jmodel, variables, model = _models(wav, norm=norm, lstm=lstm)
    roundtrip = jax.jit(lambda v, w: jmodel.apply(v, w, method=_jax_roundtrip))
    codes_ref, out_ref = (np.asarray(a) for a in roundtrip(variables, jnp.asarray(wav)))
    assert_tokens_follow_the_wav(lambda w: roundtrip(variables, jnp.asarray(w))[0], wav, codes_ref)
    codes = model.encode(torch.from_numpy(wav))
    np.testing.assert_array_equal(codes.numpy(), codes_ref)
    np.testing.assert_allclose(model.decode(codes).numpy(), out_ref, atol=1e-4, rtol=1e-3)
    has_lstm = any(isinstance(m, SLSTM) for m in model.modules())
    assert has_lstm == bool(lstm)


def test_slstm_three_layers_carry_matches_jax():
    """The N-layer plain loop against JAX's scan, from a carry, and one call
    over T equal to two calls that pass the carry along."""
    B, C, T = 2, 8, 11
    jmod = JSLSTM(dimension=C, num_layers=3)
    x = _wav(4, (B, T, C))
    params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    rng = np.random.default_rng(5)
    carry = tuple((rng.standard_normal((B, C)).astype(np.float32),) * 2 for _ in range(3))
    y_ref, final_ref = jmod.apply({"params": params}, jnp.asarray(x), carry=jax.tree_util.tree_map(jnp.asarray, carry),
                                  return_carry=True)
    mod = SLSTM(C, num_layers=3)
    mod.load_state_dict(slstm_state_from_jax(params))
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    tcarry = tuple(tuple(torch.from_numpy(a) for a in hc) for hc in carry)
    with torch.no_grad():
        y, final = mod(xt, tcarry, return_carry=True)
        y1, mid = mod(xt[..., :4], tcarry, return_carry=True)
        y2, final2 = mod(xt[..., 4:], mid, return_carry=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref).transpose(0, 2, 1), atol=1e-5, rtol=0)
    for (h, c), (h_ref, c_ref) in zip(final, final_ref):
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.cat([y1, y2], -1), y, atol=0, rtol=0)
    assert all(torch.equal(a, b) for hc, hc2 in zip(final, final2) for a, b in zip(hc, hc2))
    assert len(mod.init_carry(B)) == 3


CHUNK, T_STREAM = 40, 400  # 5 frames a chunk, 10 chunks


def test_streamed_layer_norm_lstm3_session_matches_jax():
    wav = _wav(6, (2, T_STREAM))
    jmodel, variables, model = _models(wav, causal=True, pad_mode="zero", norm="layer_norm", lstm=3)
    chunks = [wav[:, i:i + CHUNK] for i in range(0, T_STREAM, CHUNK)]
    jenc = JStreamingEncoder(jmodel, variables)
    ref = np.concatenate([np.asarray(jenc.process(jnp.asarray(c))) for c in chunks], -1)
    enc = StreamingEncoder(model)
    ours = np.concatenate([enc.process(torch.from_numpy(c)).numpy() for c in chunks], -1)
    assert ours.shape == ref.shape == (jmodel.n_q, 2, T_STREAM // 8)
    np.testing.assert_array_equal(ours, ref)
    assert len(np.unique(ref)) > 8
    code_chunks = [ref[:, :, i:i + 5] for i in range(0, ref.shape[-1], 5)]
    jdec = JStreamingDecoder(jmodel, variables)
    wav_ref = np.concatenate([np.asarray(jdec.process(jnp.asarray(c))) for c in code_chunks], -1)
    dec = StreamingDecoder(model)
    wav_ours = np.concatenate([dec.process(torch.from_numpy(c)).numpy() for c in code_chunks], -1)
    np.testing.assert_allclose(wav_ours, wav_ref, atol=1e-4, rtol=1e-3)


def test_time_group_norm_does_not_stream():
    model = SoundStream(**KW, causal=True, pad_mode="zero", norm="time_group_norm", device="cpu")
    with pytest.raises(ValueError, match="time_group_norm does not stream"):
        StreamingEncoder(model).process(torch.zeros((1, CHUNK)))
    conv = SConv1d(2, 3, 3, causal=True, norm="layer_norm")
    y, _ = conv.stream(torch.randn((1, 2, 8)))
    assert y.shape == (1, 3, 8)
    # spectral norm is a kernel norm since the HiFi-Codec trainer; an unknown norm still raises
    assert SConv1d(2, 3, 3, norm="spectral_norm").conv.conv.norm == "spectral_norm"
    with pytest.raises(ValueError, match="unsupported norm"):
        SConv1d(2, 3, 3, norm="weight_standardization")


def test_chip_smoke_layer_opts_rehearsal():
    """chip_smoke's ``layer_opts`` phase at a tiny width on the CPU: each option's
    roundtrip and the 3-layer stream run with no kernel launches."""
    import chip_smoke

    r = chip_smoke.phase_layer_opts("cpu", torch.float32, batch=2, seconds=0.2, iters=0, cross_seconds=0,
                                    stream_seconds=0.3, n_filters=4, dimension=32)
    assert sorted(r) == ["lstm=3", "norm=layer_norm", "norm=time_group_norm", "stream_lstm=3"]
    assert not any(v for opts in ("lstm=3", "norm=layer_norm", "norm=time_group_norm")
                   for v in r[opts]["launches"].values())
    assert r["stream_lstm=3"]["tokens_vs_full"] == 0.0
