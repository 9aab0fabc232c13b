"""The port's streaming sessions against the JAX package's, on the CPU.

The models are those of tests/test_streaming.py (a tiny causal Encodec with
zero padding) and tests/test_hificodec_causal.py (a tiny causal HiFi-Codec
generator), their JAX weights carried across with ``utils/convert``; the
Encodec codebooks are spread over the JAX encoder's latent frames of the
streamed wav (tests/test_torch_soundstream.py ``with_spread_codebooks``), so
that its tokens follow the wav. The contract: Encodec tokens identical to the JAX sessions', wav within atol
1e-4, rtol 1e-3; streaming equal to the port's own full causal call within
the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.models.hificodec import VQVAE as JVQVAE
from academicodec_tpu.models.soundstream import SoundStream as JSoundStream
from academicodec_tpu.nn.hifigan import HiFiCodecConfig as JHiFiCodecConfig
from academicodec_tpu.streaming import StreamingDecoder as JStreamingDecoder
from academicodec_tpu.streaming import StreamingEncoder as JStreamingEncoder
from academicodec_tpu.streaming import StreamingVQVAEDecoder as JStreamingVQVAEDecoder
from academicodec_tpu.utils.torch_export import export_soundstream

from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.conv import SConv1d, SConvTranspose1d
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.streaming import StreamingDecoder, StreamingEncoder, StreamingVQVAEDecoder
from academicodec_tpu_torch.utils.convert import hificodec_state_from_jax, soundstream_state_from_jax
from test_torch_soundstream import assert_tokens_follow_the_wav, with_spread_codebooks
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)

SS_KW = dict(n_filters=4, dimension=32, ratios=(8, 5, 4, 2), sample_rate=16000,
             target_bandwidths=(1, 2, 4), causal=True, pad_mode="zero")
CHUNK, T = 640, 3200  # 2 frames a chunk, 5 chunks

HIFI_KW = dict(
    upsample_rates=(2, 2, 2, 2), upsample_kernel_sizes=(4, 4, 4, 4), upsample_initial_channel=128,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 2), (1, 3)), encoder_base_channels=8,
    n_code_groups=2, n_codes=32, sampling_rate=16000, causal=True,
)


@pytest.fixture(scope="module")
def encodec():
    """The causal JAX model with its codebooks spread over its latent frames
    of the streamed wav ``_wav(1)``, and the port's copy."""
    jmodel = JSoundStream(**SS_KW)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(jmodel.init, static_argnames=("training",))(
        {"params": rng, "rvq": rng}, jnp.zeros((2, T)), n_q=jmodel.n_q, training=False
    )
    variables = with_spread_codebooks(jmodel, variables, _wav(1))
    model = SoundStream(**SS_KW, device="cpu")
    model.load_state_dict(soundstream_state_from_jax(variables))
    return jmodel, variables, model


def _wav(seed, batch=2, length=T):
    return (np.random.default_rng(seed).standard_normal((batch, length)) * 0.1).astype(np.float32)


def _stream(session, chunks):
    return [np.asarray(session.process(c)) for c in chunks]


def test_causal_soundstream_state_equals_export(encodec):
    """``soundstream_state_from_jax`` covers the causal SEANet tree, which is
    the non-causal one: equal to ``export_soundstream`` key for key."""
    _, variables, _ = encodec
    sd, ref = soundstream_state_from_jax(variables), export_soundstream(variables)
    assert list(sd) == list(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


def test_streaming_encoder_tokens_match_jax(encodec):
    jmodel, variables, model = encodec
    wav = _wav(1)
    chunks = [wav[:, i:i + CHUNK] for i in range(0, T, CHUNK)]
    ref = np.concatenate(_stream(JStreamingEncoder(jmodel, variables, target_bw=4), map(jnp.asarray, chunks)), -1)
    assert_tokens_follow_the_wav(
        lambda w: np.concatenate(_stream(JStreamingEncoder(jmodel, variables, target_bw=4),
                                         (jnp.asarray(w[:, i:i + CHUNK]) for i in range(0, T, CHUNK))), -1),
        wav, ref)
    ours = np.concatenate(_stream(StreamingEncoder(model, target_bw=4), map(torch.from_numpy, chunks)), -1)
    assert ours.shape == ref.shape == (jmodel.n_q_for_bandwidth(4), 2, T // 320)
    np.testing.assert_array_equal(ours, ref)
    # and the full causal encode: JAX's own bound for shape-dependent near-tie flips
    full = model.encode(torch.from_numpy(wav), target_bw=4).numpy()
    assert np.mean(ours == full) > 0.98


def test_streaming_decoder_matches_jax_and_full_decode(encodec):
    jmodel, variables, model = encodec
    codes = np.random.default_rng(2).integers(0, 64, size=(4, 2, 12)).astype(np.int32)
    chunks = [codes[:, :, i:i + 3] for i in range(0, 12, 3)]
    ref = np.concatenate(_stream(JStreamingDecoder(jmodel, variables), map(jnp.asarray, chunks)), -1)
    ours = np.concatenate(_stream(StreamingDecoder(model), map(torch.from_numpy, chunks)), -1)
    assert ours.shape == ref.shape == (2, 12 * 320)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-3)
    full = model.decode(torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(ours, full, atol=1e-4, rtol=1e-3)


def test_streaming_reset_and_interleaved_sessions(encodec):
    """The state belongs to the session: ``reset`` replays the stream, and two
    sessions interleaved on one model equal the two run one after the other."""
    _, _, model = encodec
    a, b = _wav(3, batch=1), _wav(4, batch=1)
    ca = [torch.from_numpy(a[:, i:i + CHUNK]) for i in range(0, T, CHUNK)]
    cb = [torch.from_numpy(b[:, i:i + CHUNK]) for i in range(0, T, CHUNK)]
    enc = StreamingEncoder(model, target_bw=4)
    first = _stream(enc, ca)
    enc.reset()
    np.testing.assert_array_equal(np.concatenate(_stream(enc, ca), -1), np.concatenate(first, -1))
    sa, sb = StreamingEncoder(model, target_bw=4), StreamingEncoder(model, target_bw=4)
    inter_a, inter_b = [], []
    for x, y in zip(ca, cb):
        inter_a.append(np.asarray(sa.process(x)))
        inter_b.append(np.asarray(sb.process(y)))
    np.testing.assert_array_equal(np.concatenate(inter_a, -1), np.concatenate(first, -1))
    np.testing.assert_array_equal(np.concatenate(inter_b, -1),
                                  np.concatenate(_stream(StreamingEncoder(model, target_bw=4), cb), -1))
    # decoders too: the LSTM carry and the overlap-add tails belong to the session
    codes = [torch.from_numpy(c) for c in first]
    other = [c.flip(0) for c in codes]  # another stream of valid codes
    da, db = StreamingDecoder(model), StreamingDecoder(model)
    inter_a, inter_b = [], []
    for x, y in zip(codes, other):
        inter_a.append(da.process(x))
        inter_b.append(db.process(y))
    for inter, stream in ((inter_a, codes), (inter_b, other)):
        alone = StreamingDecoder(model)
        torch.testing.assert_close(torch.cat(inter, -1), torch.cat([alone.process(c) for c in stream], -1),
                                   rtol=0, atol=0)


def test_streaming_refuses_non_causal_and_ragged_chunks(encodec):
    _, _, model = encodec
    non_causal = SoundStream(**{**SS_KW, "causal": False}, device="cpu")
    with pytest.raises(ValueError, match="causal"):
        StreamingEncoder(non_causal)
    with pytest.raises(ValueError, match="hop length"):
        StreamingEncoder(model).process(torch.zeros((1, 100)))
    with pytest.raises(ValueError, match="causal"):
        SConv1d(2, 2, 3).stream(torch.zeros((1, 2, 4)))
    with pytest.raises(ValueError, match="stride"):
        SConv1d(2, 2, 4, stride=2, causal=True).stream(torch.zeros((1, 2, 3)))
    with pytest.raises(ValueError, match="trim_right_ratio"):
        SConvTranspose1d(2, 2, 4, stride=2, causal=True, trim_right_ratio=0.5).stream(torch.zeros((1, 2, 3)))


@pytest.fixture(scope="module")
def hifi():
    jmodel = JVQVAE(config=JHiFiCodecConfig(**HIFI_KW))
    wav = jnp.asarray(np.random.default_rng(0).standard_normal((2, 640)).astype(np.float32) * 0.3)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, wav)
    model = VQVAE(HiFiCodecConfig(**HIFI_KW), device="cpu")
    model.load_reference(hificodec_state_from_jax(variables))
    toks = np.array(jmodel.apply(variables, wav, method=JVQVAE.encode))
    return jmodel, variables, model, toks


def test_causal_vqvae_full_decode_matches_jax(hifi):
    jmodel, variables, model, toks = hifi
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(toks), method=JVQVAE.decode))
    ours = model.decode(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("chunk", [1, 7, 10])
def test_streaming_vqvae_decoder_matches_jax_and_full_decode(hifi, chunk):
    jmodel, variables, model, toks = hifi
    pieces = [toks[:, i:i + chunk] for i in range(0, toks.shape[1], chunk)]
    ref = np.concatenate(_stream(JStreamingVQVAEDecoder(jmodel, variables), map(jnp.asarray, pieces)), 1)
    dec = StreamingVQVAEDecoder(model)
    ours = np.concatenate(_stream(dec, map(torch.from_numpy, pieces)), 1)
    assert ours.shape == ref.shape == (2, 640)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-3)
    full = model.decode(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(ours, full, atol=1e-4, rtol=1e-3)
    dec.reset()
    np.testing.assert_array_equal(np.asarray(dec.process(torch.from_numpy(pieces[0]))), ours[:, :chunk * 16])


@pytest.mark.parametrize("phase", ["stream", "stream_hifi", "compress"])
def test_chip_smoke_serving_phases_rehearse_on_cpu(phase):
    """``chip_smoke.py``'s serving phases drive the public entry points at a
    tiny width on the CPU: shapes, finiteness, exact tokens and wav where
    they check them, and launch counts of 0 (the plain versions run)."""
    import chip_smoke

    tiny = dict(dtype=torch.float32, seconds=0.3)
    if phase == "stream":
        r = chip_smoke.phase_stream("cpu", batch=2, n_filters=4, dimension=32, **tiny)
        assert r["chunks"] == 3 and r["chunk_samples"] == 2400
    elif phase == "stream_hifi":
        r = chip_smoke.phase_stream_hifi("cpu", batch=2, upsample_initial_channel=64, **tiny)
        assert r["chunks"] == 2
    else:
        r = chip_smoke.phase_compress("cpu", n_files=3, bucket_seconds=0.3, n_filters=4, dimension=32, **tiny)
        assert len(r["blob_bytes"]) == 3
    assert not any(r["launches"].values())
