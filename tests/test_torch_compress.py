"""The port's ECDC codec layer against the JAX package's, on the CPU.

The model is tests/test_bucketed.py's tiny SoundStream in f32, its JAX
weights carried across with ``utils/convert``. Its codebooks are spread over
the JAX encoder's latent frames of the test wavs (tests/test_torch_soundstream.py
``with_spread_codebooks``): with N(0, 1) codebooks every layer would code
every frame as one token, the tokens of an all-zero wav. The contract: blobs byte-identical to the
JAX compressor's, decoded wav within atol 1e-4 of JAX's, the native and the
numpy bit packers byte-identical.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.cli import compress as jcli
from academicodec_tpu.codec import binary as jbinary
from academicodec_tpu.codec.compress import SoundStreamCompressor as JCompressor
from academicodec_tpu.models.soundstream import SoundStream as JSoundStream
from academicodec_tpu.utils.torch_export import export_soundstream

from academicodec_tpu_torch.cli import compress as cli
from academicodec_tpu_torch.codec import binary
from academicodec_tpu_torch.codec.compress import (
    SoundStreamCompressor,
    compress_codes,
    decompress_codes,
    decompress_tokens,
)
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.native.build import get_bitpack_lib
from academicodec_tpu_torch.utils.convert import soundstream_state_from_jax
from test_torch_soundstream import assert_tokens_follow_the_wav, with_spread_codebooks

KW = dict(n_filters=4, dimension=32, ratios=(8, 5, 4, 2), sample_rate=16000, target_bandwidths=(1, 2, 4))


@pytest.fixture(scope="module")
def models():
    jmodel = JSoundStream(**KW)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(jmodel.init, static_argnames=("training",))(
        {"params": rng, "rvq": rng}, jnp.zeros((1, 3200)), n_q=jmodel.n_q, training=False
    )
    wavs = _wavs([1000, 3999, 4001, 7777])
    variables = with_spread_codebooks(jmodel, variables, np.concatenate(wavs)[None])
    model = SoundStream(**KW, device="cpu")
    model.load_state_dict(soundstream_state_from_jax(variables))
    return jmodel, variables, model


def _wavs(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(T) * 0.1).astype(np.float32) for T in lengths]


@pytest.mark.parametrize("T", [1000, 4001, 7777])
def test_compress_blob_byte_identical_to_jax(models, T):
    jmodel, variables, model = models
    wav = _wavs([T], seed=T)[0]
    ours, ref = SoundStreamCompressor(model, target_bw=4).compress(wav), \
        JCompressor(jmodel, variables, target_bw=4).compress(wav)
    assert ours == ref
    codes, meta = decompress_codes(ours)
    assert codes.shape == (jmodel.n_q_for_bandwidth(4), -(-T // 320)) and meta["audio_length"] == T
    assert_tokens_follow_the_wav(_jax_codes(jmodel, variables), wav, codes)


def _jax_codes(jmodel, variables):
    """wav -> the codes of the JAX compressor's blob."""
    return lambda w: decompress_codes(JCompressor(jmodel, variables, target_bw=4).compress(w))[0]


def test_compress_batch_bucketed_byte_identical_and_decodes_like_jax(models):
    jmodel, variables, model = models
    wavs = _wavs([1000, 3999, 4001, 7777])
    ours = SoundStreamCompressor(model, target_bw=4, bucket_seconds=0.25)
    ref = JCompressor(jmodel, variables, target_bw=4, bucket_seconds=0.25)
    blobs = ours.compress_batch(wavs, pad_to_batch=6)
    assert blobs == ref.compress_batch(wavs, pad_to_batch=6)
    for wav, blob in zip(wavs, blobs):
        assert_tokens_follow_the_wav(_jax_codes(jmodel, variables), wav, decompress_codes(blob)[0])
    out, out_ref = ours.decompress_batch(blobs, pad_to_batch=6), ref.decompress_batch(blobs, pad_to_batch=6)
    for (w, sr), (w_ref, sr_ref), wav in zip(out, out_ref, wavs):
        assert sr == sr_ref == 16000 and w.shape == wav.shape and w.dtype == np.float32
        np.testing.assert_allclose(w, w_ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.decompress(blobs[1])[0], ref.decompress(blobs[1])[0], atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="bucket_seconds"):
        SoundStreamCompressor(model).compress_batch(wavs[:2])


@pytest.mark.parametrize("bits", [1, 3, 7, 8, 10, 13, 16])
def test_native_and_python_packers_byte_identical(bits):
    """The native packer, the Python ``BitPacker`` and the JAX package's packer
    write the same bytes, and unpacking inverts them (the cases of
    tests/test_codec_bitstream.py)."""
    assert get_bitpack_lib() is not None, "native bitpack failed to build"
    vals = np.random.default_rng(bits).integers(0, 2**bits, size=999).astype(np.int32)
    blob = binary.pack_array(vals, bits)
    buf = io.BytesIO()
    packer = binary.BitPacker(bits, buf)
    for v in vals.tolist():
        packer.push(int(v))
    packer.flush()
    assert blob == buf.getvalue() == jbinary.pack_array(vals, bits) == binary.pack_array_numpy(vals, bits)
    np.testing.assert_array_equal(binary.unpack_array(blob, bits, len(vals)), vals)
    np.testing.assert_array_equal(binary.unpack_array_numpy(blob, bits, len(vals)), vals)
    unpacker = binary.BitUnpacker(bits, io.BytesIO(blob))
    rebuilt = [unpacker.pull() for _ in range(len(vals))]
    assert rebuilt == vals.tolist()
    for unpack in (binary.unpack_array, binary.unpack_array_numpy):
        with pytest.raises(EOFError):
            unpack(blob[: len(blob) // 2], bits, len(vals))


@pytest.mark.parametrize("bits", [1, 10, 13])
def test_numpy_packer_without_native(monkeypatch, bits):
    """Without the native library ``pack_array``/``unpack_array`` go through
    numpy and write the JAX package's bytes, ghost values and all."""
    import academicodec_tpu_torch.native.build as native_build

    monkeypatch.setattr(native_build, "get_bitpack_lib", lambda: None)
    for n in (0, 1, 7, 1001):
        vals = np.random.default_rng(n).integers(0, 2**bits, size=n).astype(np.int32)
        blob = binary.pack_array(vals, bits)
        assert blob == jbinary.pack_array(vals, bits)
        np.testing.assert_array_equal(binary.unpack_array(blob, bits, n), vals)


def test_bitpacker_roundtrip_fuzz():
    rng = np.random.default_rng(1234)
    for _ in range(6):
        length, bits = int(rng.integers(10, 2000)), int(rng.integers(1, 16))
        tokens = rng.integers(0, 2**bits, size=length).tolist()
        buf = io.BytesIO()
        packer = binary.BitPacker(bits, buf)
        for t in tokens:
            packer.push(int(t))
        packer.flush()
        buf.seek(0)
        unpacker = binary.BitUnpacker(bits, buf)
        rebuilt = []
        while (v := unpacker.pull()) is not None:
            rebuilt.append(v)
        assert len(tokens) <= len(rebuilt) <= len(tokens) + 8 // bits
        assert rebuilt[: len(tokens)] == tokens


def test_ecdc_header_and_codes_roundtrip_match_jax():
    codes = np.random.default_rng(5).integers(0, 1024, size=(8, 250)).astype(np.int32)
    blob = compress_codes(codes, bits_per_codebook=10, metadata={"sr": 24000})
    from academicodec_tpu.codec.compress import compress_codes as jcompress_codes

    assert blob == jcompress_codes(codes, bits_per_codebook=10, metadata={"sr": 24000})
    out, meta = decompress_codes(blob)
    np.testing.assert_array_equal(out, codes)
    assert meta["sr"] == 24000 and len(blob) < 2500 + 200
    ours, ref = io.BytesIO(), io.BytesIO()
    binary.write_ecdc_header(ours, {"sr": 24000, "n": [1, 2]})
    jbinary.write_ecdc_header(ref, {"sr": 24000, "n": [1, 2]})
    assert ours.getvalue() == ref.getvalue()
    with pytest.raises(ValueError, match="ECDC"):
        binary.read_ecdc_header(io.BytesIO(b"RIFF" + ours.getvalue()[4:]))


def test_lm_coded_blob_raises():
    fo = io.BytesIO()
    binary.write_ecdc_header(fo, {"lm": True, "n_q": 1, "n_frames": 1, "bits": 10})
    with pytest.raises(ValueError, match="LM-entropy-coded"):
        decompress_tokens(fo.getvalue())


def test_cli_writes_the_jax_cli_files(models, tmp_path, monkeypatch):
    """Both CLIs on one reference-layout ``.pth`` and two wavs written by the
    port's ``wavio``: byte-identical ``.ecdc`` files, wavs within atol 1e-4."""
    jmodel, variables, _ = models
    pth = tmp_path / "tiny.pth"
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in export_soundstream(variables).items()}, pth)
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for name, wav in zip(("a.wav", "b.wav"), _wavs([5000, 7100], seed=11)):
        write_wav(str(wav_dir / name), wav, 16000)
    flags = ["--input", str(wav_dir), "--resume_path", str(pth), "--sr", "16000", "--ratios", "8", "5", "4", "2",
             "--target_bandwidths", "1", "2", "4", "--target_bw", "4", "--n_filters", "4", "--dimension", "32",
             "--ecdc", "--bucket_seconds", "0.5", "--batch_files", "2"]
    cli.main(flags + ["--output", str(tmp_path / "ours"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["compress", *flags, "--output", str(tmp_path / "ref")])
    jcli.main()
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref")) == \
        ["a.ecdc", "a.wav", "b.ecdc", "b.wav"]
    for name, wav in zip(("a", "b"), _wavs([5000, 7100], seed=11)):
        blob = (tmp_path / "ours" / f"{name}.ecdc").read_bytes()
        assert blob == (tmp_path / "ref" / f"{name}.ecdc").read_bytes()
        assert_tokens_follow_the_wav(_jax_codes(jmodel, variables), wav, decompress_codes(blob)[0])
        ours, sr = read_wav(str(tmp_path / "ours" / f"{name}.wav"))
        ref, sr_ref = read_wav(str(tmp_path / "ref" / f"{name}.wav"))
        assert sr == sr_ref == 16000 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(SystemExit):
        cli.get_args(["--input", ".", "--output", ".", "--resume_path", str(tmp_path)])  # an orbax directory
    pth = tmp_path / "x.pth"
    pth.write_bytes(b"")
    with pytest.raises(SystemExit):
        cli.get_args(["--input", ".", "--output", ".", "--resume_path", str(pth), "--batch_files", "2"])
    with pytest.raises(SystemExit):
        cli.get_args(["--input", ".", "--output", ".", "--resume_path", str(pth), "--lm", "dir"])
    assert cli.get_args(["--input", ".", "--output", ".", "--resume_path", str(pth)]).device == "cuda"
