"""HiFi-Codec corpus tokenization in the port against the JAX package, on the CPU.

The length-masked encode (``VQVAE.encode(lengths=)``: a zero-padded batch
of files of different lengths, each row equal to its exact-length encode),
weight-norm folding (``utils/fold.py``), ``list_audio_files`` and the
``extract_tokens`` CLI. The models are tiny; their JAX weights go across
with ``utils/convert`` (or a reference ``g_*`` file, for the CLIs), and the
GRVQ codebooks are spread over the JAX encoder's latent frames
(tests/test_torch_hificodec.py), so that tokens follow the wav. Contracts:
tokens identical, ECDC blobs byte-identical, wavs within atol 1e-4 / rtol
1e-3 across the packages and atol 1e-5 between a folded and an unfolded
model of one package.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.cli import extract_tokens as jcli
from academicodec_tpu.data.dataset import list_audio_files as jlist_audio_files
from academicodec_tpu.models.hificodec import VQVAE as JVQVAE
from academicodec_tpu.models.soundstream import SoundStream as JSoundStream
from academicodec_tpu.nn.hifigan import HiFiCodecConfig as JConfig
from academicodec_tpu.utils.fold import fold_soundstream as jfold_soundstream
from academicodec_tpu.utils.fold import fold_vqvae as jfold_vqvae

from academicodec_tpu_torch.cli import extract_tokens as cli
from academicodec_tpu_torch.codec.compress import decompress_tokens
from academicodec_tpu_torch.data.dataset import list_audio_files
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.utils.convert import hificodec_state_from_jax
from academicodec_tpu_torch.utils.fold import fold_soundstream, fold_vqvae
from test_torch_hificodec import _spread_codebooks
from test_torch_soundstream import OPERATING_POINTS, _jax_model, _port_model, _test_wav

# encoder stages of 32 and 64 channels (K4, with lengths) and 128 (the
# unfused masked stage); generator stages of 64 and 32 channels (K3)
TINY = dict(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=128,
            encoder_base_channels=16, n_codes=64)
LENGTHS = (1777, 2400, 3999)  # tests/test_bucketed.py:318-347


@pytest.fixture(scope="module")
def vqvae():
    """The tiny JAX VQVAE with codebooks spread over its latent frames of the
    test wavs, and the port's copy."""
    jmodel = JVQVAE(config=JConfig(**TINY))
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 640)))
    wavs = _wavs(LENGTHS)
    variables = _spread_codebooks(jmodel, variables, np.concatenate(wavs)[None], seed=3)
    model = VQVAE(config=HiFiCodecConfig(**TINY), device="cpu")
    model.load_reference(hificodec_state_from_jax(variables))
    return jmodel, variables, model


def _wavs(lengths, seed=13):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def _padded(wavs):
    n = max(len(w) for w in wavs)
    return np.stack([np.pad(w, (0, n - len(w))) for w in wavs])


def test_masked_encode_matches_jax_and_exact_lengths(vqvae):
    """One padded batch with lengths: tokens identical to JAX's masked encode
    (academicodec_tpu/models/hificodec.py:84-97), and each row's valid frames
    identical to its exact-length encode, in both packages."""
    jmodel, variables, model = vqvae
    wavs = _wavs(LENGTHS)
    batch = _padded(wavs)
    ref = np.asarray(jax.jit(lambda v, w, n: jmodel.apply(v, w, lengths=n, method=JVQVAE.encode))(
        variables, jnp.asarray(batch), jnp.asarray(LENGTHS, jnp.int32)))
    codes = model.encode(torch.from_numpy(batch), lengths=torch.tensor(LENGTHS))
    np.testing.assert_array_equal(codes.numpy(), ref)
    assert len(np.unique(ref)) > 8
    jencode = jax.jit(lambda v, w: jmodel.apply(v, w, method=JVQVAE.encode))
    for i, w in enumerate(wavs):
        alone = model.encode(torch.from_numpy(w[None])).numpy()
        assert alone.shape[1] == model.frames_for(len(w))
        np.testing.assert_array_equal(codes[i, :alone.shape[1]].numpy(), alone[0])
        np.testing.assert_array_equal(ref[i, :alone.shape[1]], np.asarray(jencode(variables, jnp.asarray(w[None])))[0])


def test_fold_vqvae_matches_jax_and_the_unfolded_model(vqvae):
    jmodel, variables, model = vqvae
    folded = fold_vqvae(model)
    assert not any(n.endswith(("weight_v", "weight_g")) for n, _ in folded.named_parameters())
    assert model.encoder.conv_pre.norm == "weight_norm" and folded.encoder.conv_pre.norm == "none"
    fmodel, fvars = jfold_vqvae(jmodel, variables)
    wav = _wavs([2400], seed=5)[0][None]
    ref = np.asarray(fmodel.apply(fvars, jnp.asarray(wav), method=JVQVAE.encode))
    codes = folded.encode(torch.from_numpy(wav))
    np.testing.assert_array_equal(codes.numpy(), ref)
    np.testing.assert_array_equal(codes.numpy(), model.encode(torch.from_numpy(wav)).numpy())
    out = folded.decode(codes).numpy()
    np.testing.assert_allclose(out, np.asarray(fmodel.apply(fvars, jnp.asarray(ref), method=JVQVAE.decode)),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out, model.decode(codes).numpy(), atol=1e-5, rtol=0)


def test_fold_soundstream_matches_jax_and_the_unfolded_model():
    ratios, sr, bws = OPERATING_POINTS[0]
    wav = _test_wav(0, (2, 4800))
    jmodel, variables = _jax_model(ratios, sr, bws, wav=wav)
    model = _port_model(variables, ratios, sr, bws)
    folded = fold_soundstream(model)
    assert not any(n.endswith(("weight_v", "weight_g")) for n, _ in folded.named_parameters())
    fmodel, fvars = jfold_soundstream(jmodel, variables)
    ref = np.asarray(fmodel.apply(fvars, jnp.asarray(wav), method=JSoundStream.encode))
    codes = folded.encode(torch.from_numpy(wav))
    np.testing.assert_array_equal(codes.numpy(), ref)
    np.testing.assert_array_equal(codes.numpy(), model.encode(torch.from_numpy(wav)).numpy())
    out = folded.decode(codes).numpy()
    np.testing.assert_allclose(out, np.asarray(fmodel.apply(fvars, jnp.asarray(ref), method=JSoundStream.decode)),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out, model.decode(codes).numpy(), atol=1e-5, rtol=0)


def test_list_audio_files(tmp_path):
    (tmp_path / "d" / "sub").mkdir(parents=True)
    for name in ("b.wav", "a.wav", "sub/c.wav", "notes.txt"):
        (tmp_path / "d" / name).write_bytes(b"")
    found = list_audio_files(str(tmp_path / "d"))
    assert found == jlist_audio_files(str(tmp_path / "d"))
    assert [os.path.relpath(f, tmp_path / "d") for f in found] == ["a.wav", "b.wav", "sub/c.wav"]
    lst = tmp_path / "list.txt"
    lst.write_text("x/1.wav\n\n  y/2.wav  \n")
    assert list_audio_files(str(lst)) == jlist_audio_files(str(lst)) == ["x/1.wav", "y/2.wav"]


@pytest.fixture(scope="module")
def corpus(vqvae, tmp_path_factory):
    """The model as a reference ``g_*`` file, its config JSON, and three wavs of
    one and two 0.1 s buckets."""
    _, variables, _ = vqvae
    root = tmp_path_factory.mktemp("corpus")
    torch.save(hificodec_state_from_jax(variables), root / "g_00000001")
    with open(root / "config.json", "w") as fh:
        json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}, fh)
    (root / "in").mkdir()
    for name, w in zip(("a", "b", "c"), _wavs((1500, 2600, 4100), seed=21)):
        write_wav(str(root / "in" / f"{name}.wav"), w, 24000)
    return root


def _flags(root):
    return ["--config", str(root / "config.json"), "--model_path", str(root / "g_00000001"),
            "--input", str(root / "in")]


def test_extract_tokens_cli_matches_jax_batched_and_sequential(corpus, tmp_path, monkeypatch):
    """The port's CLI batched (lengths, two files a call) and one file a call
    at exact lengths, and the JAX CLI batched from the same ``g_*`` file: the
    same tokens, byte-identical ECDC blobs, synthesized wavs within atol 1e-4."""
    runs = {}
    for tag, extra in (("batched", ["--batch_files", "2", "--bucket_seconds", "0.1"]), ("single", [])):
        out = tmp_path / tag
        tokens = cli.main(_flags(corpus) + extra + ["--outputdir", str(out), "--tokens_out", str(out / "t.npz"),
                                                    "--tokens_ecdc", str(out / "ecdc"), "--device", "cpu"])
        assert sorted(tokens) == ["a", "b", "c"]
        runs[tag] = out
    monkeypatch.setattr(sys, "argv", ["extract_tokens", *_flags(corpus), "--batch_files", "2", "--bucket_seconds",
                                      "0.1", "--outputdir", str(tmp_path / "jax"), "--tokens_out",
                                      str(tmp_path / "jax" / "t.npz"), "--tokens_ecdc", str(tmp_path / "jax" / "ecdc")])
    jcli.main()
    runs["jax"] = tmp_path / "jax"
    ref = np.load(runs["jax"] / "t.npz")
    for tag, out in runs.items():
        got = np.load(out / "t.npz")
        assert sorted(got.files) == sorted(ref.files) == ["a", "b", "c"]
        for name in ("a", "b", "c"):
            np.testing.assert_array_equal(got[name], ref[name], err_msg=f"{tag}/{name}")
            blob = (out / "ecdc" / f"{name}.ecdc").read_bytes()
            assert blob == (runs["jax"] / "ecdc" / f"{name}.ecdc").read_bytes(), f"{tag}/{name}"
            np.testing.assert_array_equal(decompress_tokens(blob)[0], ref[name][0].T)
    assert len(np.unique(np.concatenate([ref[n].reshape(-1) for n in ref.files]))) > 8
    for name in ("a", "b", "c"):
        ours, sr = read_wav(str(runs["batched"] / f"{name}.wav"))
        theirs, sr_ref = read_wav(str(runs["jax"] / f"{name}.wav"))
        assert sr == sr_ref == 24000 and ours.shape == theirs.shape == (ref[name].shape[1] * 32,)
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("extra,message", [
    (["--lm", "lm_dir", "--tokens_ecdc", "x"], "Queue 1 item 8"),
    (["--int8_min_channels", "128"], "Queue 1 item 3"),
    (["--data_parallel", "--batch_files", "2", "--bucket_seconds", "1"], "Queue 1 item 9"),
    (["--sequence_parallel"], "Queue 1 item 9"),
    (["--batch_files", "2"], "needs --bucket_seconds"),
])
def test_extract_tokens_cli_refuses_what_is_not_ported(corpus, tmp_path, capsys, extra, message):
    with pytest.raises(SystemExit):
        cli.get_args(_flags(corpus) + ["--outputdir", str(tmp_path)] + extra)
    assert message in capsys.readouterr().err


def test_extract_tokens_cli_refuses_a_checkpoint_directory(corpus, tmp_path, capsys):
    flags = _flags(corpus)
    flags[flags.index("--model_path") + 1] = str(tmp_path)
    with pytest.raises(SystemExit):
        cli.get_args(flags + ["--outputdir", str(tmp_path)])
    assert "orbax" in capsys.readouterr().err
    assert cli.get_args(_flags(corpus) + ["--outputdir", str(tmp_path)]).device == "cuda"
