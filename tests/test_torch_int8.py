"""W8A8 int8 HiFi-Codec serving in the port against the JAX package, on the CPU.

The quantize helpers and the int8 conv (``ops/int8.py``: the plain version,
an f64 convolution, on the CPU), ``Conv1d(w8a8=True)`` and
``calibrate_quant`` (``models/hificodec.py``), and the ``extract_tokens``
CLI with ``--int8_min_channels``. The model has stages wider than 64
channels, so that int8 has sites in the port, which fuses the narrower ones:
the encoder's 32- and 64-channel stages (K4) and 128-channel stage, the
generator's 128-channel stage and its 64- and 32-channel ones (K3); at
threshold 128 JAX's unfused model quantizes exactly the port's sites. A
1e-7 difference in an activation can move it across a rounding boundary, so
serving parity takes JAX's calibrated scales (``hificodec_quant_from_jax``),
and the port's own calibration is checked against JAX's separately. Even
with the same scales the two packages' f32 rounding can move an activation
to the next integer and a token with it: a two-stage variant of this model
(upsample rates (4, 2), 2 x 1600 samples) gave 3 of 1600 tokens apart.
Contracts: int8 values and scales bitwise, int32 sums exact, outputs within
1e-6 relative, scales within rtol 1e-5, tokens identical and wav within atol
1e-4.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from academicodec_tpu.cli import extract_tokens as jcli
from academicodec_tpu.models.hificodec import VQVAE as JVQVAE
from academicodec_tpu.models.hificodec import calibrate_quant as jcalibrate_quant
from academicodec_tpu.nn.hifigan import HiFiCodecConfig as JConfig
from academicodec_tpu.ops import int8 as jint8
from academicodec_tpu.ops.conv import DN_1D

from academicodec_tpu_torch.cli import extract_tokens as cli
from academicodec_tpu_torch.data.wavio import read_wav, write_wav
from academicodec_tpu_torch.models.hificodec import VQVAE, calibrate_quant
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig, HiFiGANGenerator
from academicodec_tpu_torch.ops import int8
from academicodec_tpu_torch.utils.convert import hificodec_quant_from_jax, hificodec_state_from_jax
from test_torch_hificodec import TINY, _spread_codebooks

THRESHOLD = 128
INT8_SITES = ("encoder.resblocks.6", "encoder.resblocks.7", "encoder.resblocks.8",
              "generator.resblocks.0", "generator.resblocks.1", "generator.resblocks.2")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread keeps parallel
    pytest workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng_f32(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_quantize_helpers_match_jax_bitwise():
    w = _rng_f32(0, (24, 16, 5), 0.2)  # [O, I, K]
    wi, scale = int8.quantize_kernel_per_cout(torch.from_numpy(w))
    wi_ref, scale_ref = jint8.quantize_kernel_per_cout(jnp.asarray(w.transpose(2, 1, 0)))
    np.testing.assert_array_equal(wi.numpy(), np.asarray(wi_ref).transpose(2, 1, 0))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref))
    assert wi.dtype == torch.int8 and scale.dtype == torch.float32
    # halves land on even integers in both, and clipping at +-127
    x = np.concatenate([np.arange(-300, 301) * 0.25, _rng_f32(1, 400, 20.0)]).astype(np.float32)
    act_scale = np.float32(0.5)
    xi = int8.quantize_act(torch.from_numpy(x), torch.tensor(act_scale))
    np.testing.assert_array_equal(xi.numpy(), np.asarray(jint8.quantize_act(jnp.asarray(x), act_scale)))
    assert xi.numpy().min() == -127 and xi.numpy().max() == 127


@pytest.mark.parametrize("stride,dilation,padding", [(1, 2, (4, 4)), (3, 1, (2, 1))])
def test_conv1d_w8a8_matches_jax(stride, dilation, padding):
    """int32 sums exactly JAX's ``lax.conv`` ones, at a width where they pass
    2^24; the dequantized output within 1e-6 relative."""
    C, O, K = 512, 24, 11
    x = _rng_f32(2, (2, C, 40), 3.0)
    w = _rng_f32(3, (O, C, K), 0.05)
    b = _rng_f32(4, O, 0.1)
    act_scale = torch.tensor(np.float32(np.abs(x).max() / 127.0))
    xi = int8.quantize_act(torch.from_numpy(x), act_scale)
    wi, _ = int8.quantize_kernel_per_cout(torch.from_numpy(w))
    sums = int8.conv1d_int32(xi, wi, stride, dilation, padding)
    sums_ref = lax.conv_general_dilated(
        jnp.asarray(xi.numpy().transpose(0, 2, 1)), jnp.asarray(wi.numpy().transpose(2, 1, 0)),
        window_strides=(stride,), padding=(padding,), rhs_dilation=(dilation,), dimension_numbers=DN_1D,
        preferred_element_type=jnp.int32)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(sums_ref).transpose(0, 2, 1))
    # hificodec_24k_320d's largest int8 sum, 11 * 512 * 127^2, past f32's 2^24, still exact
    full = int8.conv1d_int32(torch.full((1, C, 30), 127, dtype=torch.int8),
                             torch.full((O, C, K), 127, dtype=torch.int8), stride, dilation, (0, 0))
    assert (full == K * C * 127 * 127).all() and K * C * 127 * 127 > 2**24
    y = int8.conv1d_w8a8(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), act_scale,
                         stride=stride, dilation=dilation, padding=padding)
    y_ref = np.asarray(jint8.conv1d_w8a8(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(w.transpose(2, 1, 0)),
                                         jnp.asarray(b), jnp.float32(act_scale.item()), stride=stride,
                                         dilation=dilation, padding=padding)).transpose(0, 2, 1)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-6, atol=1e-6 * np.abs(y_ref).max())


@pytest.fixture(scope="module")
def models():
    """JAX's unfused model (codebooks spread over its latent frames of the
    test wav) with its calibrated ``'quant'`` collection and int8 roundtrip,
    and the port's int8 copy, uncalibrated."""
    wav = _rng_f32(5, (2, 3200), 0.1)
    jfp = JVQVAE(config=JConfig(**TINY))  # the int8 model's parameters, serving at full precision
    variables = jax.jit(jfp.init)({"params": jax.random.PRNGKey(6)}, jnp.zeros((1, 640)))
    variables = _spread_codebooks(jfp, variables, wav, seed=6)
    jmodel = jfp.clone(int8_min_channels=THRESHOLD)
    calibrated = jcalibrate_quant(jmodel, variables, jnp.asarray(wav))
    codes = jax.jit(lambda v, w: jmodel.apply(v, w, method=JVQVAE.encode))(calibrated, jnp.asarray(wav))
    out = jax.jit(lambda v, c: jmodel.apply(v, c, method=JVQVAE.decode))(calibrated, codes)
    model = VQVAE(config=HiFiCodecConfig(**TINY), int8_min_channels=THRESHOLD, device="cpu")
    model.load_reference(hificodec_state_from_jax(variables))
    return dict(wav=wav, variables=variables, quant=calibrated["quant"], codes=np.asarray(codes),
                out=np.asarray(out), model=model)


def test_int8_sites_are_the_unfused_wide_stages(models):
    sites = sorted(models["model"].w8a8_convs())
    assert sorted(hificodec_quant_from_jax(models["quant"])) == sites
    assert len(sites) == 6 * 6 and all(s.startswith(INT8_SITES) for s in sites)
    # a threshold at or below the fused width quantizes nothing more: fused stages take no int8 site
    assert sorted(VQVAE(config=HiFiCodecConfig(**TINY), int8_min_channels=16, device="cpu").w8a8_convs()) == sites
    with pytest.raises(ValueError, match="no causal variant"):
        HiFiGANGenerator(HiFiCodecConfig(**TINY, causal=True), int8_min_channels=THRESHOLD)


def test_uncalibrated_serving_raises(models):
    model = VQVAE(config=HiFiCodecConfig(**TINY), int8_min_channels=THRESHOLD, device="cpu")
    with pytest.raises(ValueError, match="calibrate_quant"):
        model.encode(torch.from_numpy(models["wav"]))


def test_calibrate_quant_matches_jax(models):
    import copy

    model = calibrate_quant(copy.deepcopy(models["model"]), torch.from_numpy(models["wav"]))
    ref = hificodec_quant_from_jax(models["quant"])
    ours = {name: conv.act_amax for name, conv in model.w8a8_convs().items()}
    assert sorted(ours) == sorted(ref)
    for name, amax in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), amax.numpy(), rtol=1e-5, err_msg=name)
        assert not model.w8a8_convs()[name].calibrating


def test_int8_serving_with_jax_scales_matches_jax(models):
    model = models["model"]
    model.load_quant(hificodec_quant_from_jax(models["quant"]))
    calls = int8.INT_MM_CALLS
    codes = model.encode(torch.from_numpy(models["wav"]))
    np.testing.assert_array_equal(codes.numpy(), models["codes"])
    assert len(np.unique(models["codes"])) > 8
    np.testing.assert_allclose(model.decode(codes).numpy(), models["out"], atol=1e-4, rtol=1e-3)
    assert int8.INT_MM_CALLS == calls  # the plain versions on the CPU


def test_extract_tokens_int8_cli_matches_jax(models, tmp_path, monkeypatch):
    """Both CLIs with ``--int8_min_channels 128`` on one ``g_*`` file: each
    calibrates on the first file itself, and the tokens and wavs agree."""
    torch.save(hificodec_state_from_jax(models["variables"]), tmp_path / "g_00000001")
    with open(tmp_path / "config.json", "w") as fh:
        json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}, fh)
    (tmp_path / "in").mkdir()
    for i, w in enumerate(models["wav"]):
        write_wav(str(tmp_path / "in" / f"f{i}.wav"), w, 24000)
    flags = ["--config", str(tmp_path / "config.json"), "--model_path", str(tmp_path / "g_00000001"),
             "--input", str(tmp_path / "in"), "--int8_min_channels", str(THRESHOLD), "--normalize"]
    cli.main(flags + ["--outputdir", str(tmp_path / "ours"), "--tokens_out", str(tmp_path / "ours.npz"),
                      "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["extract_tokens", *flags, "--outputdir", str(tmp_path / "jax"),
                                      "--tokens_out", str(tmp_path / "jax.npz")])
    jcli.main()
    ours, ref = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(ours.files) == sorted(ref.files) == ["f0", "f1"]
    for name in ref.files:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
        a, _ = read_wav(str(tmp_path / "ours" / f"{name}.wav"))
        b, _ = read_wav(str(tmp_path / "jax" / f"{name}.wav"))
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def test_chip_smoke_int8_rehearsal():
    """chip_smoke's ``int8`` phase at a tiny width on the CPU: no kernel
    launches and no int8 GEMMs (the plain versions run), the int8 decode
    within JAX's 0.12 of the full-precision one, the card check's CPU copy
    equal to itself."""
    import chip_smoke

    r = chip_smoke.phase_int8("cpu", torch.float32, batch=1, seconds=0.1, cross_seconds=0.05, **TINY)
    assert not any(r["launches"].values()) and r["int8_gemms"] == 0 and r["int8_convs"] == 36
    assert r["wav_rel_l2_same_tokens"] <= 0.12 and r["cross_token_mismatch"] == 0.0
