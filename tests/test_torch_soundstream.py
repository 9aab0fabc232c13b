"""The port's SoundStream slice end to end against the JAX package, on the CPU.

JAX variables are carried across with ``soundstream_state_from_jax``; the
same seeded wav goes through both. The contract is the JAX package's own
(tests/test_model_parity.py): tokens identical, wav within atol 1e-4 /
rtol 1e-3 at tiny width and atol 2e-4 at flagship width.

The codebooks are redrawn from the JAX encoder's latent frames of the wav a
test encodes (:func:`with_spread_codebooks`), as tests/test_torch_hificodec.py
redraws the GRVQ codebooks: N(0, 1) codebooks lie far from the random encoders' latents, so every layer
would emit one token for every frame, the tokens of an all-zero wav. Each
token test therefore also asserts more than 8 distinct tokens and a nonzero
mismatch against the zero wav's tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from academicodec_tpu.models import presets as jpresets
from academicodec_tpu.models.soundstream import SoundStream as JSoundStream
from academicodec_tpu.utils.torch_export import export_soundstream

from academicodec_tpu_torch import api
from academicodec_tpu_torch.models import presets
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.utils.convert import soundstream_state_from_jax
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)


def with_spread_codebooks(model, variables, wav, seed: int = 0) -> dict:
    """``variables`` with the RVQ codebooks redrawn from the JAX encoder's
    latent frames of ``wav [B, T]``, as tests/test_torch_hificodec.py redraws
    the GRVQ codebooks: entries N(0, std^2) per latent dimension, except
    layer 0's first entry, the frames' mean, which every frame picks. The
    residuals of later layers are then centred, and their distances are
    well conditioned in f32: entries drawn around the mean instead leave
    |r|^2 hundreds of times the nearest distance at the flagship width,
    where both packages' f32 rounding flips near-ties."""
    e = np.asarray(jax.jit(lambda v, w: model.apply(v, w[..., None], method=lambda m, x: m.encoder(x)))(
        variables, jnp.asarray(wav)))
    frames = e.reshape(-1, e.shape[-1])
    shape = variables["codebook"]["quantizer"]["vq"]["embed"].shape
    embed = np.random.default_rng(seed).standard_normal(shape) * frames.std(axis=0)
    embed[0, 0] = frames.mean(axis=0)
    embed = jnp.asarray(embed.astype(np.float32))
    codebook = {
        "embed": embed, "embed_avg": embed,
        "cluster_size": jnp.ones(shape[:2]), "inited": jnp.ones(shape[:1], bool),
    }
    return {"params": variables["params"], "codebook": {"quantizer": {"vq": codebook}}}


def assert_tokens_follow_the_wav(encode, wav, codes_ref) -> None:
    """The tokens spread (more than 8 distinct) and differ from those of an
    all-zero wav of the same shape, so that equal tokens test the path from
    latents to tokens."""
    assert len(np.unique(codes_ref)) > 8
    assert np.mean(np.asarray(encode(np.zeros_like(wav))) != codes_ref) > 0


def _jax_model(ratios, sr, bws, n_filters=4, dimension=32, seed=0, wav=None):
    """A JAX SoundStream with seeded random weights and codebooks spread over
    its latent frames of ``wav`` (default: the seeded test wav of ``seed``)."""
    model = JSoundStream(n_filters=n_filters, dimension=dimension, ratios=ratios,
                         sample_rate=sr, target_bandwidths=bws)
    rng = jax.random.PRNGKey(seed)
    variables = jax.jit(model.init, static_argnames=("training",))(
        {"params": rng, "rvq": rng}, jnp.zeros((1, 4800)), n_q=model.n_q, training=False
    )
    if wav is None:
        wav = _test_wav(seed, (2, 4800))
    return model, with_spread_codebooks(model, variables, wav, seed)


def _test_wav(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def _port_model(variables, ratios, sr, bws, n_filters=4, dimension=32):
    model = SoundStream(n_filters=n_filters, dimension=dimension, ratios=ratios, sample_rate=sr,
                        target_bandwidths=bws, device="cpu")
    model.load_state_dict(soundstream_state_from_jax(variables))
    return model


def _jax_roundtrip(model, variables, wav, target_bw=None, st=0):
    codes = jax.jit(lambda v, w: model.apply(v, w, target_bw=target_bw, st=st,
                                             method=JSoundStream.encode))(variables, jnp.asarray(wav))
    out = jax.jit(lambda v, c: model.apply(v, c, method=JSoundStream.decode))(variables, codes)
    return np.asarray(codes), np.asarray(out)


OPERATING_POINTS = [
    ((8, 5, 4, 2), 16000, (1, 1.5, 2, 4, 6, 12)),
    ((6, 5, 4, 2), 24000, (1, 2, 4, 8, 12)),
    ((2, 2, 2, 4), 24000, (7.5, 15)),
]


def test_state_from_jax_equals_export_soundstream():
    _, variables = _jax_model(*OPERATING_POINTS[1])
    sd, ref = soundstream_state_from_jax(variables), export_soundstream(variables)
    assert list(sd) == list(ref)
    for key, value in ref.items():
        assert sd[key].dtype == torch.float32
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


def _jax_encode(model, variables, **kw):
    return lambda w: jax.jit(lambda v, x: model.apply(v, x, method=JSoundStream.encode, **kw))(
        variables, jnp.asarray(w))


@pytest.mark.parametrize("ratios,sr,bws", OPERATING_POINTS)
def test_tiny_soundstream_matches_jax(ratios, sr, bws):
    wav = _test_wav(0, (2, 4800))
    jmodel, variables = _jax_model(ratios, sr, bws, wav=wav)
    model = _port_model(variables, ratios, sr, bws)
    assert (model.n_q, model.frame_rate, model.hop_length) == (jmodel.n_q, jmodel.frame_rate, jmodel.hop_length)
    codes_ref, out_ref = _jax_roundtrip(jmodel, variables, wav, target_bw=bws[-1])
    assert_tokens_follow_the_wav(_jax_encode(jmodel, variables, target_bw=bws[-1]), wav, codes_ref)
    codes = model.encode(torch.from_numpy(wav), target_bw=bws[-1])
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), codes_ref)
    np.testing.assert_allclose(model.decode(codes).numpy(), out_ref, atol=1e-4, rtol=1e-3)


def test_partial_stack_encode_matches_jax():
    """``st > 0`` with a bandwidth below the maximum (SpearTTS-style extraction)."""
    ratios, sr, bws = OPERATING_POINTS[0]
    wav = _test_wav(1, (1, 4800))
    jmodel, variables = _jax_model(ratios, sr, bws, seed=1, wav=wav)
    model = _port_model(variables, ratios, sr, bws)
    codes_ref, _ = _jax_roundtrip(jmodel, variables, wav, target_bw=6, st=2)
    assert_tokens_follow_the_wav(_jax_encode(jmodel, variables, target_bw=6, st=2), wav, codes_ref)
    np.testing.assert_array_equal(model.encode(torch.from_numpy(wav), target_bw=6, st=2).numpy(), codes_ref)


def test_flagship_width_soundstream_matches_jax():
    """n_filters 32, D 512 (H 512 LSTM, 12 codebooks of 1024): the widths the
    tiny models cannot reach."""
    ratios, sr, bws = OPERATING_POINTS[1]
    wav = _test_wav(5, (2, 7200))
    jmodel, variables = _jax_model(ratios, sr, bws, n_filters=32, dimension=512, seed=5, wav=wav)
    model = _port_model(variables, ratios, sr, bws, n_filters=32, dimension=512)
    assert model.n_q == 12
    codes_ref, out_ref = _jax_roundtrip(jmodel, variables, wav)
    assert_tokens_follow_the_wav(_jax_encode(jmodel, variables), wav, codes_ref)
    codes = model.encode(torch.from_numpy(wav))
    np.testing.assert_array_equal(codes.numpy(), codes_ref)
    np.testing.assert_allclose(model.decode(codes).numpy(), out_ref, atol=2e-4, rtol=1e-3)


def test_load_codec_defaults_to_the_card(monkeypatch):
    """With no card, the default device raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_codec("encodec_24k_240d")


def test_load_codec_reads_a_reference_checkpoint(tmp_path):
    ratios, sr, bws = OPERATING_POINTS[1]
    _, variables = _jax_model(ratios, sr, bws)
    path = tmp_path / "best.pth"
    torch.save({"soundstream": {f"module.{k}": v for k, v in soundstream_state_from_jax(variables).items()}}, path)
    model = api.load_codec("encodec_24k_240d", str(path), device="cpu", n_filters=4, dimension=32)
    ref = _port_model(variables, ratios, sr, bws)
    for key, value in ref.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


def test_presets_match_jax():
    assert presets.SOUNDSTREAM_PRESETS == jpresets.SOUNDSTREAM_PRESETS
    assert presets.HIFICODEC_PRESETS == jpresets.HIFICODEC_PRESETS
    # every JAX preset, and Mimi and DAC, which only the port has
    assert presets.names() == sorted(jpresets.names() + list(presets.MIMI_PRESETS) + list(presets.DAC_PRESETS))
    with pytest.raises(KeyError):
        presets.build("no_such_preset", device="cpu")


def test_chip_smoke_main_path_rehearsal():
    """chip_smoke's main-path phase at a tiny width on the CPU: shapes, finite
    output, and no kernel launches (the CPU runs the plain versions)."""
    result = chip_smoke.phase_main_path(
        device="cpu", dtype=torch.float32, batch=2, seconds=0.2, iters=0, n_filters=4, dimension=32
    )
    assert result["launches"] == {"rvq_encode": 0, "lstm2": 0, "resblock_tower": 0, "resblock_tower_gn": 0}
    assert tuple(result["codes"].shape) == (12, 2, 20)
    assert tuple(result["wav"].shape) == (2, 4800)
