"""LM entropy coding in the port against the JAX package, on the CPU.

The streaming transformer (``nn/transformer.py``) and the token LM
(``models/lm.py``), their JAX weights carried across with
``utils/convert.lm_state_from_jax``; the range coder (``codec/ac.py``) fed
JAX's pdfs; LM coding and the raw-or-LM guard (``codec/lm_compress.py``,
``codec/compress.py``); the LM checkpoints and both CLIs with ``--lm``.
A "biased" LM has its head biases set to the log frequencies of the tokens
it codes, as tests/test_lm_compress.py biases its heads, so that LM coding
wins. Contracts: the transformer within atol 1e-5 step by step and in
chunks, probabilities within atol 1e-6, the coder's bytes identical to
JAX's on JAX's pdfs, LM blobs lossless, the guard's raw blob identical to
JAX's.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.codec.compress import compress_tokens_guarded as jcompress_tokens_guarded
from academicodec_tpu.codec.lm_compress import _make_step as jmake_step
from academicodec_tpu.codec.lm_compress import compress_tokens_with_lm as jcompress_tokens_with_lm
from academicodec_tpu.models.lm import RVQTokenLM as JRVQTokenLM

from academicodec_tpu_torch.cli import compress as compress_cli
from academicodec_tpu_torch.cli import extract_tokens as extract_cli
from academicodec_tpu_torch.codec.ac import ArithmeticCoder, ArithmeticDecoder, build_stable_quantized_cdf
from academicodec_tpu_torch.codec.binary import read_ecdc_header, write_ecdc_header
from academicodec_tpu_torch.codec.compress import compress_codes, compress_tokens_guarded, decompress_tokens
from academicodec_tpu_torch.codec.lm_compress import compress_tokens_with_lm, decompress_tokens_with_lm, make_step
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.lm import RVQTokenLM, load_lm, save_lm
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.utils.convert import lm_state_from_jax

LM_KW = dict(n_q=3, bins=32, dim=32, num_heads=4, num_layers=2, past_context=6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread keeps parallel
    pytest workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lms():
    """A seeded JAX LM (head biases drawn too, so that they matter) and the port's copy."""
    jlm = JRVQTokenLM(**LM_KW)
    params = dict(jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, LM_KW["n_q"]), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    for q in range(LM_KW["n_q"]):
        params[f"head_{q}"] = {**params[f"head_{q}"], "bias": jnp.asarray(rng.standard_normal(LM_KW["bins"]),
                                                                            jnp.float32)}
    variables = {"params": params}
    lm = RVQTokenLM(**LM_KW, device="cpu")
    lm.load_state_dict(lm_state_from_jax(params))
    return jlm, variables, lm


def _codes(seed, T, n_q=3, bins=32):
    return np.random.default_rng(seed).integers(0, bins, (n_q, T)).astype(np.int32)


def test_lm_state_from_jax_covers_every_parameter(lms):
    _, variables, lm = lms
    sd = lm_state_from_jax(variables["params"])
    assert sorted(sd) == sorted(lm.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(variables["params"]))
    assert len(sd) == n_leaves
    with pytest.raises(KeyError):
        lm_state_from_jax({**variables["params"], "extra": {}})


def test_transformer_step_by_step_and_in_chunks_matches_jax(lms):
    """The trunk over 10 frames: one frame a call with the fixed rolling
    states (past the 6-frame context, so the buffer rolls), and in chunks of
    4 with growing states, each against JAX's call of the same kind."""
    jlm, variables, lm = lms
    x = np.random.default_rng(2).standard_normal((2, 10, LM_KW["dim"])).astype(np.float32)

    def jtrunk(m, x, states, offset, fixed_state):
        return m.transformer(x, states=states, offset=offset, fixed_state=fixed_state)

    jstep = jax.jit(lambda v, x, s, o: jlm.apply(v, x, s, o, True, method=jtrunk))
    jstates, offset = jlm.init_states(2), jnp.int32(0)
    states, toff = lm.transformer.init_states(2), torch.tensor(0)
    for t in range(10):
        y_ref, jstates, offset = jstep(variables, jnp.asarray(x[:, t:t + 1]), jstates, offset)
        with torch.no_grad():
            y, states, toff = lm.transformer(torch.from_numpy(x[:, t:t + 1]), states, toff, fixed_state=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=0, err_msg=f"step {t}")
    jstates, states = None, None
    for t in range(0, 10, 4):
        y_ref, jstates, _ = jlm.apply(variables, jnp.asarray(x[:, t:t + 4]), jstates, t, False, method=jtrunk)
        with torch.no_grad():
            y, states, _ = lm.transformer(torch.from_numpy(x[:, t:t + 4]), states, t)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=0, err_msg=f"chunk {t}")


def _jax_pdfs(jlm, variables, codes):
    """JAX's step pdfs ``[T, n_q, bins]`` along ``codes [n_q, T]``."""
    step = jmake_step(jlm, variables)
    n_q, T = codes.shape
    prev, states, offset, pdfs = jnp.full((1, 1, n_q), jlm.bins, jnp.int32), None, 0, []
    for t in range(T):
        pdf, states, offset = step(prev, states, offset)
        pdfs.append(pdf)
        prev = jnp.asarray(codes[:, t].reshape(1, 1, n_q))
    return np.stack(pdfs)


def test_probabilities_match_jax(lms):
    jlm, variables, lm = lms
    codes = _codes(3, 9)
    ref = _jax_pdfs(jlm, variables, codes)
    step = make_step(lm)
    prev, states, offset = torch.full((1, 1, 3), lm.bins), None, None
    for t in range(codes.shape[1]):
        pdf, states, offset = step(prev, states, offset)
        assert pdf.dtype == np.float64 and pdf.shape == (3, 32)
        np.testing.assert_allclose(pdf, ref[t], atol=1e-6, rtol=0, err_msg=f"frame {t}")
        prev = torch.from_numpy(codes[:, t].astype(np.int64).reshape(1, 1, 3))


def test_range_coder_writes_jax_bytes_on_jax_pdfs(lms):
    jlm, variables, _ = lms
    codes = _codes(4, 12)
    blob_ref = jcompress_tokens_with_lm(jlm, variables, codes, metadata={"sr": 16000})
    pdfs = _jax_pdfs(jlm, variables, codes)
    fo = io.BytesIO()
    write_ecdc_header(fo, {"sr": 16000, "n_q": 3, "n_frames": 12, "lm": True})
    coder = ArithmeticCoder(fo)
    for t in range(12):
        for q in range(3):
            p = pdfs[t, q]
            coder.push(int(codes[q, t]), build_stable_quantized_cdf(p / p.sum(), coder.total_range_bits))
    coder.flush()
    assert fo.getvalue() == blob_ref
    fi = io.BytesIO(blob_ref)
    read_ecdc_header(fi)
    decoder = ArithmeticDecoder(fi)
    out = [[decoder.pull(build_stable_quantized_cdf(pdfs[t, q] / pdfs[t, q].sum(), 24)) for q in range(3)]
           for t in range(12)]
    np.testing.assert_array_equal(np.array(out).T, codes)


def test_lm_roundtrip_is_lossless(lms):
    _, _, lm = lms
    codes = _codes(5, 15)  # past the 6-frame context
    blob = compress_tokens_with_lm(lm, codes, metadata={"sr": 24000})
    out, meta = decompress_tokens_with_lm(lm, blob)
    np.testing.assert_array_equal(out, codes)
    assert meta["lm"] is True and meta["sr"] == 24000 and meta["n_frames"] == 15
    with pytest.raises(ValueError, match="not LM-coded"):
        decompress_tokens_with_lm(lm, compress_codes(codes, bits_per_codebook=5, metadata={}))


def test_guard_with_untrained_lm_gives_jax_raw_blob(lms):
    jlm, variables, lm = lms
    codes = _codes(6, 40)  # uniform tokens: no LM beats 5-bit packing
    blob = compress_tokens_guarded(codes, bits_per_codebook=5, metadata={"sr": 16000}, lm=lm)
    ref = jcompress_tokens_guarded(codes, bits_per_codebook=5, metadata={"sr": 16000}, lm=jlm,
                                   lm_variables=variables)
    assert blob == ref == compress_codes(codes, bits_per_codebook=5, metadata={"sr": 16000})
    np.testing.assert_array_equal(decompress_tokens(blob)[0], codes)


def _bias_heads(lm, codes):
    """Head biases set to the log frequencies of ``codes [n_q, T]`` per stream."""
    with torch.no_grad():
        for q, head in enumerate(lm.heads):
            freq = np.bincount(codes[q], minlength=lm.bins) + 0.01
            head.bias.copy_(torch.from_numpy(np.log(freq / freq.sum())).float())


def test_biased_lm_gives_a_smaller_blob_that_roundtrips():
    lm = RVQTokenLM(**LM_KW, device="cpu", seed=3)
    codes = np.random.default_rng(7).choice(4, (3, 40), p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
    _bias_heads(lm, codes)
    blob = compress_tokens_guarded(codes, bits_per_codebook=5, metadata={}, lm=lm)
    assert len(blob) < len(compress_codes(codes, bits_per_codebook=5, metadata={}))
    out, meta = decompress_tokens(blob, lm=lm)
    np.testing.assert_array_equal(out, codes)
    assert meta["lm"] is True
    with pytest.raises(ValueError, match="LM-entropy-coded"):
        decompress_tokens(blob)


def test_save_and_load_lm(tmp_path, lms):
    _, _, lm = lms
    save_lm(lm, str(tmp_path), step=3, family="hificodec", trained_frames=75)
    path = save_lm(lm, str(tmp_path), step=12, family="hificodec", trained_frames=75)
    assert os.path.basename(path) == "lm_00000012.pt"
    cfg = json.load(open(tmp_path / "lm_config.json"))
    assert cfg == {**LM_KW, "family": "hificodec", "trained_frames": 75}
    loaded, meta = load_lm(str(tmp_path), expect_family="hificodec", expect_nq=3, expect_bins=32, device="cpu")
    assert meta == {"family": "hificodec", "trained_frames": 75}
    for key, value in lm.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    assert load_lm(path, device="cpu")[1] == meta
    with pytest.raises(ValueError, match="models 'hificodec' token streams"):
        load_lm(str(tmp_path), expect_family="encodec", device="cpu")
    with pytest.raises(ValueError, match="LM shape mismatch"):
        load_lm(str(tmp_path), expect_nq=4, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_lm(str(tmp_path / "none"), device="cpu")


SS_KW = dict(n_filters=4, dimension=32, ratios=(8, 5, 4, 2), sample_rate=16000, target_bandwidths=(1, 2))
SS_FLAGS = ["--sr", "16000", "--ratios", "8", "5", "4", "2", "--target_bandwidths", "1", "2", "--target_bw", "2",
            "--n_filters", "4", "--dimension", "32", "--device", "cpu"]


def test_compress_cli_with_lm_roundtrips(tmp_path, capsys):
    """``--lm`` with an LM biased to the codec's tokens: LM-coded ``.ecdc``
    files, smaller than the raw ones, that decode to the raw files' tokens and
    wavs; an LM of another family or stream count exits with a message."""
    model = SoundStream(**SS_KW, device="cpu", seed=1)
    torch.save(model.state_dict(), tmp_path / "ss.pth")
    (tmp_path / "in").mkdir()
    wavs = [(np.random.default_rng(8 + i).standard_normal(3200 + 640 * i) * 0.1).astype(np.float32) for i in range(2)]
    for i, w in enumerate(wavs):
        write_wav(str(tmp_path / "in" / f"w{i}.wav"), w, 16000)
    n_q = model.n_q_for_bandwidth(2)
    codes = np.concatenate([model.encode(torch.from_numpy(w[None]), target_bw=2)[:, 0].numpy() for w in wavs], 1)
    lm = RVQTokenLM(n_q=n_q, bins=1024, dim=16, num_heads=2, num_layers=1, past_context=8, device="cpu")
    _bias_heads(lm, codes)
    save_lm(lm, str(tmp_path / "lm"), family="encodec", trained_frames=10)
    flags = ["--input", str(tmp_path / "in"), "--resume_path", str(tmp_path / "ss.pth"), "--ecdc", *SS_FLAGS]
    compress_cli.main(flags + ["--output", str(tmp_path / "raw")])
    compress_cli.main(flags + ["--output", str(tmp_path / "lmout"), "--lm", str(tmp_path / "lm")])
    # w0 is 10 frames, the trained length; w1 is 12
    assert "NOTE: w1.wav is 12 frames" in capsys.readouterr().err
    for i in range(2):
        raw = (tmp_path / "raw" / f"w{i}.ecdc").read_bytes()
        coded = (tmp_path / "lmout" / f"w{i}.ecdc").read_bytes()
        assert read_ecdc_header(io.BytesIO(coded))["lm"] is True and len(coded) < len(raw)
        np.testing.assert_array_equal(decompress_tokens(coded, lm=lm)[0], decompress_tokens(raw)[0])
        np.testing.assert_array_equal(read_wav(str(tmp_path / "lmout" / f"w{i}.wav"))[0],
                                      read_wav(str(tmp_path / "raw" / f"w{i}.wav"))[0])
    save_lm(lm, str(tmp_path / "lm_hifi"), family="hificodec")
    with pytest.raises(SystemExit, match="models 'hificodec' token streams"):
        compress_cli.main(flags + ["--output", str(tmp_path / "x"), "--lm", str(tmp_path / "lm_hifi")])
    with pytest.raises(SystemExit, match="LM shape mismatch"):
        compress_cli.main(flags + ["--output", str(tmp_path / "x"), "--lm", str(tmp_path / "lm"),
                                   "--target_bw", "1"])


HIFI = dict(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=64,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), encoder_base_channels=8, n_codes=64)


def test_extract_tokens_cli_with_lm_roundtrips(tmp_path):
    """``--tokens_ecdc --lm``: every blob decodes to the ``.npz`` tokens, LM-coded
    where the biased LM wins; a family or shape mismatch exits with a message."""
    model = VQVAE(config=HiFiCodecConfig(**HIFI), device="cpu", seed=2)
    torch.save({p: getattr(model, p).state_dict() for p in ("encoder", "generator", "quantizer")},
               tmp_path / "g_00000001")
    with open(tmp_path / "config.json", "w") as fh:
        json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in HIFI.items()}, fh)
    (tmp_path / "in").mkdir()
    wavs = [(np.random.default_rng(20 + i).standard_normal(1600 + 320 * i) * 0.1).astype(np.float32) for i in range(2)]
    for i, w in enumerate(wavs):
        write_wav(str(tmp_path / "in" / f"f{i}.wav"), w, 24000)
    codes = np.concatenate([model.encode(torch.from_numpy(w[None]))[0].numpy().T for w in wavs], 1)
    lm = RVQTokenLM(n_q=4, bins=64, dim=16, num_heads=2, num_layers=1, past_context=8, device="cpu")
    _bias_heads(lm, codes)
    save_lm(lm, str(tmp_path / "lm"), family="hificodec")
    flags = ["--config", str(tmp_path / "config.json"), "--model_path", str(tmp_path / "g_00000001"),
             "--input", str(tmp_path / "in"), "--outputdir", str(tmp_path / "out"), "--no_synth",
             "--tokens_out", str(tmp_path / "t.npz"), "--device", "cpu"]
    extract_cli.main(flags + ["--tokens_ecdc", str(tmp_path / "ecdc"), "--lm", str(tmp_path / "lm")])
    tokens = np.load(tmp_path / "t.npz")
    for name in ("f0", "f1"):
        blob = (tmp_path / "ecdc" / f"{name}.ecdc").read_bytes()
        assert read_ecdc_header(io.BytesIO(blob))["lm"] is True
        np.testing.assert_array_equal(decompress_tokens(blob, lm=lm)[0], tokens[name][0].T)
    with pytest.raises(SystemExit):
        extract_cli.get_args(flags + ["--lm", str(tmp_path / "lm")])  # --lm without --tokens_ecdc
    save_lm(lm, str(tmp_path / "lm_enc"), family="encodec")
    with pytest.raises(SystemExit, match="models 'encodec' token streams"):
        extract_cli.main(flags + ["--tokens_ecdc", str(tmp_path / "e2"), "--lm", str(tmp_path / "lm_enc")])
    save_lm(RVQTokenLM(n_q=3, bins=64, dim=16, num_heads=2, num_layers=1, device="cpu"), str(tmp_path / "lm3"))
    with pytest.raises(SystemExit, match="LM shape mismatch"):
        extract_cli.main(flags + ["--tokens_ecdc", str(tmp_path / "e3"), "--lm", str(tmp_path / "lm3")])


def test_chip_smoke_lm_rehearsal():
    """chip_smoke's ``lm`` phase at a tiny width on the CPU: no kernel launches
    (the plain versions run), an LM blob smaller than the raw one that decodes
    exactly (asserted inside), and the CPU's blob decoding on the CPU."""
    import chip_smoke

    r = chip_smoke.phase_lm("cpu", torch.float32, seconds=0.5, n_filters=4, dimension=32,
                            lm_width=dict(dim=16, num_heads=2, num_layers=1, past_context=8))
    assert not any(r["launches"].values())
    assert r["bits_per_token"]["lm"] < r["bits_per_token"]["raw_blob"]
    assert r["frames"] == 50 and r["card_blob_decodes_on_cpu"]
