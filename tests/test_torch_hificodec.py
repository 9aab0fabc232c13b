"""The port's HiFi-Codec slice end to end against the JAX package, on the CPU.

JAX variables are carried across with ``hificodec_state_from_jax``; the
same seeded wav goes through both. The JAX ``VQVAE`` runs its default plain
lowering, which the JAX package holds equal to its fused towers
(tests/test_pallas_resblock.py:143-176); the port's CPU path runs the K3/K4
plain versions on its narrow stages. The contract is the JAX package's own
(tests/test_model_parity.py:139-188): tokens identical, wav within atol
1e-4 / rtol 1e-3 at tiny width and atol 2e-4 / rtol 1e-3 at full width.

Codebooks are redrawn N(0, s^2), with s the JAX encoder output's std, so the
tokens spread over the codebooks (the reference init, uniform +-1/1024, is
far smaller than the latents).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from academicodec_tpu.models import presets as jpresets
from academicodec_tpu.models.hificodec import VQVAE as JVQVAE
from academicodec_tpu.nn.hifigan import HiFiCodecConfig as JConfig
from academicodec_tpu.utils.torch_export import export_hificodec

from academicodec_tpu_torch import api
from academicodec_tpu_torch.models import presets
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.ops.cuda import resblock as rb_ops
from academicodec_tpu_torch.utils.convert import hificodec_state_from_jax
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)

# encoder stages ch 32, 64 (K4) and 128 (plain); generator 128 (plain), 64 (K3)
# and 32 (K3 with conv_post + tanh)
TINY = dict(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
            upsample_initial_channel=256, encoder_base_channels=16)


def _jax_model(cfg_kw, seed=0):
    model = JVQVAE(config=JConfig(**cfg_kw))
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 640)))
    return model, variables


def _spread_codebooks(model, variables, wav, seed):
    enc = jax.jit(lambda v, w: model.apply(v, w[..., None], method=lambda m, x: m.encoder(x)))
    s = float(np.asarray(enc(variables, jnp.asarray(wav))).std())
    shape = variables["params"]["quantizer"]["codebooks"].shape
    cb = (np.random.default_rng(seed).standard_normal(shape) * s).astype(np.float32)
    params = dict(variables["params"])
    params["quantizer"] = {"codebooks": jnp.asarray(cb)}
    return {"params": params}


def _jax_roundtrip(model, variables, wav):
    codes = jax.jit(lambda v, w: model.apply(v, w, method=JVQVAE.encode))(variables, jnp.asarray(wav))
    out = jax.jit(lambda v, c: model.apply(v, c, method=JVQVAE.decode))(variables, codes)
    return np.asarray(codes), np.asarray(out)


def _port_model(variables, cfg_kw):
    model = VQVAE(config=HiFiCodecConfig(**cfg_kw), device="cpu")
    model.load_reference(hificodec_state_from_jax(variables))
    return model


def _check_roundtrip(cfg_kw, wav, seed, atol):
    jmodel, variables = _jax_model(cfg_kw, seed)
    variables = _spread_codebooks(jmodel, variables, wav, seed)
    codes_ref, out_ref = _jax_roundtrip(jmodel, variables, wav)
    model = _port_model(variables, cfg_kw)
    assert model.hop_length == jmodel.hop_length
    launches = (rb_ops.TOWER_LAUNCHES, rb_ops.GN_TOWER_LAUNCHES)
    codes = model.encode(torch.from_numpy(wav))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), codes_ref)
    assert len(np.unique(codes_ref)) > 8  # the tokens spread
    out = model.decode(codes)
    assert (rb_ops.TOWER_LAUNCHES, rb_ops.GN_TOWER_LAUNCHES) == launches  # plain versions on the CPU
    np.testing.assert_allclose(out.numpy(), out_ref, atol=atol, rtol=1e-3)


def test_state_from_jax_equals_export_hificodec():
    _, variables = _jax_model(TINY)
    sd, ref = hificodec_state_from_jax(variables), export_hificodec(variables)
    assert list(sd) == list(ref)
    for part, ref_part in ref.items():
        assert list(sd[part]) == list(ref_part), part
        for key, value in ref_part.items():
            assert sd[part][key].dtype == torch.float32
            np.testing.assert_array_equal(sd[part][key].numpy(), value, err_msg=f"{part}/{key}")


def test_port_state_dict_is_the_reference_layout():
    """The port's VQVAE holds exactly the keys and shapes of a reference g_* file."""
    _, variables = _jax_model(TINY)
    ref = export_hificodec(variables)
    model = VQVAE(config=HiFiCodecConfig(**TINY), device="cpu")
    for part in ("encoder", "generator", "quantizer"):
        sd = getattr(model, part).state_dict()
        assert sorted(sd) == sorted(ref[part]), part
        for key, value in ref[part].items():
            assert tuple(sd[key].shape) == value.shape, f"{part}/{key}"


def test_tiny_vqvae_matches_jax():
    from conftest import reinvoke_isolated

    if not reinvoke_isolated(__file__, "test_tiny_vqvae_matches_jax", "ACT_TORCH_HIFI_TINY_INNER"):
        return
    wav = (np.random.default_rng(0).standard_normal((2, 3200)) * 0.1).astype(np.float32)
    _check_roundtrip(TINY, wav, seed=0, atol=1e-4)


def test_full_width_vqvae_matches_jax():
    """hificodec_24k_320d at full width (latent 512, 2 x 2 x 1024 codes) on a
    short input: the widths the tiny model cannot reach."""
    from conftest import reinvoke_isolated

    if not reinvoke_isolated(__file__, "test_full_width_vqvae_matches_jax", "ACT_TORCH_HIFI_FULL_INNER"):
        return
    cfg = {k: v for k, v in presets.HIFICODEC_PRESETS["hificodec_24k_320d"].items()}
    wav = (np.random.default_rng(2).standard_normal((1, 4800)) * 0.1).astype(np.float32)
    _check_roundtrip(cfg, wav, seed=2, atol=2e-4)


def test_load_codec_reads_a_reference_checkpoint(tmp_path):
    _, variables = _jax_model(TINY, seed=1)
    ckpt = hificodec_state_from_jax(variables)
    ckpt["generator"] = {f"module.{k}": v for k, v in ckpt["generator"].items()}  # DDP prefixes
    path = tmp_path / "g_00000001"
    torch.save(ckpt, path)
    model = api.load_codec("hificodec_24k_320d", str(path), device="cpu", **TINY)
    ref = _port_model(variables, TINY)
    for key, value in ref.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


def test_load_codec_random_weights_are_seeded():
    a = api.load_codec("hificodec_24k_320d", device="cpu", seed=3, **TINY)
    b = api.load_codec("hificodec_24k_320d", device="cpu", seed=3, **TINY)
    for key, value in a.state_dict().items():
        assert torch.equal(b.state_dict()[key], value), key
    assert a.generator.ups[0].weight_v.std() < 0.02  # N(0, 0.01^2), as the JAX package draws ups


def test_load_codec_hificodec_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_codec("hificodec_24k_320d")


def test_config_from_json():
    d = {"resblock": "2", "upsample_rates": [8, 5, 4, 2], "resblock_dilation_sizes": [[1, 3], [1, 3]],
         "unknown_key": 1}
    assert HiFiCodecConfig.from_json(d) == HiFiCodecConfig(
        resblock="2", upsample_rates=(8, 5, 4, 2), resblock_dilation_sizes=((1, 3), (1, 3)))
    assert HiFiCodecConfig().latent_dim == JConfig().latent_dim == 512


def test_chip_smoke_hificodec_rehearsal():
    """chip_smoke's HiFi-Codec phase at a tiny width on the CPU: shapes, finite
    output, spread tokens, and no kernel launches (the CPU runs the plain versions)."""
    result = chip_smoke.phase_hificodec(
        device="cpu", dtype=torch.float32, batch=2, seconds=0.2, iters=0, **TINY
    )
    assert result["launches"] == {"rvq_encode": 0, "lstm2": 0, "resblock_tower": 0, "resblock_tower_gn": 0}
    assert tuple(result["codes"].shape) == (2, 150, 4)
    assert tuple(result["wav"].shape) == (2, 4800)
    assert result["distinct_tokens"] > 8


def test_generator_fused_pre_matches_jax():
    """The generator with each fused stage's upsampling convT run as K3's
    prologue (``fused_pre``; the plain versions on the CPU) against JAX's
    ``HiFiGANGenerator(fused_resblock=True, fused_pre=True)`` (the Pallas
    towers in interpret mode) on the same weights, and against the port's own
    ``fused_pre=False``: atol 1e-4, rtol 1e-3."""
    from academicodec_tpu.nn.hifigan import HiFiGANGenerator as JGenerator

    from academicodec_tpu_torch.nn.hifigan import HiFiGANGenerator
    from academicodec_tpu_torch.utils.convert import hifigan_state_from_jax

    cfg = dict(TINY, upsample_initial_channel=128)
    jgen = JGenerator(config=JConfig(**cfg), fused_resblock=True, fused_pre=True)
    z = (np.random.default_rng(4).standard_normal((2, 12, JConfig(**cfg).latent_dim)) * 0.5).astype(np.float32)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(4), jnp.asarray(z))
    ref = np.asarray(jax.jit(jgen.apply)(params, jnp.asarray(z)))[..., 0]
    gen = HiFiGANGenerator(HiFiCodecConfig(**cfg), fused_pre=True)
    gen.load_state_dict(hifigan_state_from_jax(params["params"], transposed_ups=True))
    x = torch.from_numpy(np.ascontiguousarray(z.transpose(0, 2, 1)))
    with torch.no_grad():
        out = gen(x)[:, 0].numpy()
        gen.fused_pre = False
        unfused = gen(x)[:, 0].numpy()
    assert out.shape == ref.shape == (2, 12 * 32)
    assert np.abs(ref).max() > 1e-3  # the output is not vanishingly small
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out, unfused, atol=1e-4, rtol=1e-3)


def test_chip_smoke_extract_stages_rehearsal():
    """chip_smoke's ``extract_stages`` at a tiny width on the CPU: every encoder
    stage captured in the batched and the exact-length encodes, which agree
    here token for token (the JAX contract on the CPU)."""
    tiny = dict(TINY, n_codes=64)
    r = chip_smoke.phase_extract_stages("cpu", bucket_seconds=0.2, n_files=3, min_seconds=0.1, max_seconds=0.3,
                                        **tiny)
    for backend in ("cudnn", "native"):
        stages = r[backend]["max_rel_diff_by_stage"]
        assert r[backend]["tokens_differ"] == 0 and r[backend]["files_differ"] == []
        assert {"conv_pre", "conv_post", "conv_post.in", "ups.0", "ups.0.in"} <= set(stages)
        assert max(stages.values()) <= 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_chip_smoke_groupnorm_f32_statistics_match_the_module_on_the_cpu(masked):
    """``chip_smoke._groupnorm_f32_forward`` (the f32 statistics that
    ``phase_extract_groupnorm`` times against the f64 ones) is
    ``GroupNormTorch.forward`` bit for bit on the CPU, where the module keeps
    f32 sums, with and without a length mask."""
    from academicodec_tpu_torch.nn.hifigan import GroupNormTorch

    gn = GroupNormTorch(4, 16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        gn.weight.copy_(torch.randn(16, generator=g))
        gn.bias.copy_(torch.randn(16, generator=g))
        x = torch.randn((3, 16, 50), generator=g)
        kw = {}
        if masked:
            count = torch.tensor([50, 31, 7])
            kw = dict(mask=(torch.arange(50)[None] < count[:, None]).float()[:, None], count=count)
        assert torch.equal(chip_smoke._groupnorm_f32_forward(gn, x, **kw), gn(x, **kw))
