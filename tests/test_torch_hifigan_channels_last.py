"""The HiFi-Codec wide stages on a channels-last ``[B, C, 1, T]`` activation, on the CPU.

In 16-bit on the card the stages wider than K3/K4's 64 channels run their
convs as 2-D convs over ``[B, C, 1, T]`` channels-last tensors
(``nn/conv.py``, ``nn/hifigan.channels_last_stages``), so that cuDNN's NHWC
kernels read and write the activations as they are. Held here in f32:

* each conv of the published config's shapes (resblock k 3/7/11 at d 1/3/5,
  the strided convs, the conv-transposes, ``conv_pre`` / ``conv_post``) on a
  ``[B, C, 1, T]`` channels-last input against the 1-D conv, and its output
  channels-last; a ``w8a8`` conv refuses that input;
* the encoder and generator with the decision forced on
  (``channels_last_stages`` patched: the same stage code the card runs)
  against the ``[B, C, T]`` path: latents, tokens, the decoded wav, and under
  autograd the training forward's outputs and every gradient, to f32
  rounding;
* the counters ``towers.cl_convs`` / ``towers.layout_copies``: with the card
  check patched (``on_card``), a bf16 roundtrip counts every wide-stage conv
  and two layout changes, the published config's counted on the meta device
  (98 and 2); f32, a length-masked encode, an int8 model, a causal
  generator and an Encodec call count 0.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from academicodec_tpu_torch.models.hificodec import VQVAE, calibrate_quant
from academicodec_tpu_torch.models.presets import HIFICODEC_PRESETS
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn import hifigan
from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig, HiFiGANEncoder, HiFiGANGenerator
from academicodec_tpu_torch.utils import profiling

# encoder stages of 32 and 64 channels (K4's plain version), then 128 (wide);
# generator stages of 128 (wide), then 64 and 32 (K3's plain version); hop 32
BASE = dict(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=256,
            encoder_base_channels=16, n_codes=64)
CONFIGS = {
    "resblock1": dict(BASE),
    "resblock2": dict(BASE, resblock="2", resblock_dilation_sizes=((1, 3), (1, 3), (1, 3))),
}
SAMPLES = 3200
COUNTERS = ("towers.cl_convs", "towers.layout_copies")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wav(batch=2, seed=7) -> torch.Tensor:
    return torch.from_numpy((np.random.default_rng(seed).standard_normal((batch, SAMPLES)) * 0.1).astype(np.float32))


_MODELS = {}


def _model(config: str, dtype=torch.float32, **kw):
    """The tiny model, its codebooks spread over its latent frames (so that tokens follow the latents)."""
    key = (config, dtype, tuple(sorted(kw.items())))
    if key not in _MODELS:
        model = VQVAE(HiFiCodecConfig(**CONFIGS[config]), device="cpu", dtype=dtype, **kw)
        chip_smoke.spread_codebooks(model, chip_smoke.latent_frames(model, _wav()))
        _MODELS[key] = model
    return _MODELS[key]


def _force_channels_last(monkeypatch):
    monkeypatch.setattr(hifigan, "channels_last_stages", lambda *args, **kw: True)


def _counts(run):
    profiling.reset(*COUNTERS)
    out = run()
    return out, tuple(profiling.total(name).count for name in COUNTERS)


def _stage_convs(blocks) -> int:
    return sum(isinstance(m, Conv1d) for rb in blocks for m in rb.modules())


def _expected_counts(model, fused_pre=False):
    """``(towers.cl_convs, towers.layout_copies)`` of one roundtrip, from the
    config: each wide stage's strided conv or conv-transpose and resblock convs,
    the encoder's ``conv_post``, the generator's ``conv_pre`` and the
    conv-transpose into its first fused stage (K3's own with ``fused_pre``);
    one layout change into the encoder's wide stages and one out of the
    generator's."""
    enc, gen = model.encoder, model.generator
    wide = [i for i in range(len(enc.ups)) if not enc.fused_stage(i)]
    convs = sum(1 + _stage_convs(enc.stage(i)[0]) for i in wide) + (1 if wide else 0)
    copies = 1 if wide else 0
    wide = [i for i in range(len(gen.ups)) if not gen.fused_stage(i)]
    if wide:
        convs += 1 + sum(1 + _stage_convs(gen.stage(i)) for i in wide)
        if len(wide) < len(gen.ups):
            convs += 0 if fused_pre else 1
            copies += 1
    return convs, copies


def _conv_cases():
    h = HiFiCodecConfig(**HIFICODEC_PRESETS["hificodec_24k_320d"])
    res = [(f"res_k{k}_d{d}", dict(ci=128, co=128, k=k, d=d, p=hifigan.get_padding(k, d)))
           for k in h.resblock_kernel_sizes for d in (1, 3, 5)]
    strided = [(f"strided_k{k}_s{u}", dict(ci=64, co=128, k=k, s=u, p=(k - u) // 2))
               for u, k in zip(h.upsample_rates, h.upsample_kernel_sizes) if u > 2]
    ends = [("generator_conv_pre", dict(ci=h.latent_dim, co=256, k=7, p=3)),
            ("encoder_conv_post", dict(ci=h.latent_dim, co=h.latent_dim, k=3, p=1, norm="none")),
            ("generator_conv_post", dict(ci=32, co=1, k=7, p=3))]
    convt = [(f"convT_k{k}_s{u}", dict(ci=128, co=64, k=k, s=u, p=(k - u) // 2, transpose=True))
             for u, k in zip(h.upsample_rates, h.upsample_kernel_sizes)]
    return res + strided + ends + convt


CONV_CASES = _conv_cases()


@pytest.mark.parametrize("T", [90, 97], ids=["T90", "T97"])
@pytest.mark.parametrize("case", [c for _, c in CONV_CASES], ids=[n for n, _ in CONV_CASES])
def test_channels_last_conv_equals_the_1d_conv(case, T):
    """f32: the 2-D conv over ``[B, C, 1, T]`` channels-last equals the 1-D conv
    over ``[B, C, T]`` to f32 rounding, its output channels-last, one
    ``towers.cl_convs`` a call. A dilated conv runs as its phases
    (``conv_phases``): T 90 is a multiple of every dilation, T 97 of none."""
    g = torch.Generator().manual_seed(case["k"] * 10 + case.get("d", 1))
    s, norm = case.get("s", 1), case.get("norm", "weight_norm")
    if case.get("transpose"):
        conv = ConvTranspose1d(case["ci"], case["co"], case["k"], stride=s, padding=case["p"], norm=norm)
    else:
        conv = Conv1d(case["ci"], case["co"], case["k"], stride=s, dilation=case.get("d", 1), padding=case["p"],
                      norm=norm)
    conv.reset_parameters(g)
    x = torch.randn(2, case["ci"], T, generator=g)
    with torch.no_grad():
        want = conv(x)
        x4 = x.unsqueeze(2).contiguous(memory_format=torch.channels_last)
        y, counts = _counts(lambda: conv(x4))
    assert counts == (1, 0)
    assert y.shape == (2, case["co"], 1, want.shape[-1])
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y.squeeze(2), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("calibrated", [False, True])
def test_w8a8_conv_refuses_a_channels_last_input(calibrated):
    conv = Conv1d(128, 128, 3, padding=1, w8a8=True)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 128, 1, 20).contiguous(memory_format=torch.channels_last)
    if calibrated:
        conv.act_amax = torch.tensor(1.0)
    with pytest.raises(ValueError, match="w8a8 Conv1d takes"):
        conv(x)


@pytest.mark.parametrize("fused_pre", [False, True], ids=["k3", "k3_fused_pre"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_channels_last_stages_equal_the_nct_path(monkeypatch, config, fused_pre):
    """f32, the decision forced on: the encoder's latents (each frame's channels
    contiguous) and the wav decoded from the same tokens agree with the ``[B,
    C, T]`` path to f32 rounding, and the counters read the config's count.
    Tokens: at most 1% apart (another conv algorithm's f32 rounding flips a
    near-tie of this tiny model: 0-2 of 800 over 3 seeds and both configs)."""
    model = _model(config)
    model.generator.fused_pre = fused_pre
    wav = _wav(seed=11)

    def latents():
        with torch.no_grad():
            return model.encoder(wav[:, None])

    def roundtrip():  # the decode takes the [B, C, T] path's tokens
        return model.encode(wav), model.decode(codes)

    try:
        codes = model.encode(wav)
        lat, (_, out) = latents(), roundtrip()
        _force_channels_last(monkeypatch)
        lat_cl = latents()
        (codes_cl, out_cl), counts = _counts(roundtrip)
    finally:
        model.generator.fused_pre = False
    assert lat_cl.shape == lat.shape and lat_cl.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(lat_cl, lat, rtol=1e-5, atol=1e-6)
    assert len(torch.unique(codes)) > 8
    assert (codes_cl != codes).double().mean().item() <= 0.01
    torch.testing.assert_close(out_cl, out, rtol=1e-5, atol=1e-6)
    assert counts == _expected_counts(model, fused_pre) and counts[0] > 0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_channels_last_training_forward_and_gradients(monkeypatch, config):
    """f32 under autograd (every stage unfused, the generator channels-last to
    its ``conv_post``): the training forward's wav and loss, and the gradient of
    every parameter, agree with the ``[B, C, T]`` path to f32 rounding."""
    model = _model(config)
    wav = _wav(seed=3)

    def step():
        model.zero_grad()
        y, loss_q, codes = model(wav, training=True)
        (y.square().mean() + loss_q).backward()
        return y.detach(), loss_q.detach(), codes, {n: p.grad.clone() for n, p in model.named_parameters()}

    y, loss, codes, grads = step()
    _force_channels_last(monkeypatch)
    (y_cl, loss_cl, codes_cl, grads_cl), counts = _counts(step)
    model.zero_grad()
    assert counts[0] > 0
    assert torch.equal(codes_cl, codes)
    torch.testing.assert_close(y_cl, y, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss_cl, loss, rtol=1e-5, atol=0)
    for name, g in grads.items():
        scale = g.abs().max().item()
        torch.testing.assert_close(grads_cl[name], g, rtol=0, atol=1e-4 * scale + 1e-12, msg=name)


def test_the_published_configs_counts(monkeypatch):
    """At the published widths (the meta device: shapes only, no layouts; K3/K4
    stubbed by their output shapes), a bf16 roundtrip runs 58 encoder and 40 generator
    convs channels-last (39 with ``fused_pre``) and changes the layout twice."""
    monkeypatch.setattr(hifigan, "on_card", lambda x: True)
    monkeypatch.setattr(hifigan, "resblock_tower_gn", lambda x, *args, **kw: torch.empty_like(x))
    monkeypatch.setattr(HiFiGANEncoder, "packed_tower", lambda self, i: None)
    # K3's stand-in: its fused upsampling conv-transpose (a 1-D conv here), then one channel out of the last

    def k3(x, pre, post_tanh):
        y = x if pre is None else pre(x)
        return y[:, :1] if post_tanh else y

    monkeypatch.setattr(hifigan, "resblock_tower", k3)
    monkeypatch.setattr(HiFiGANGenerator, "packed_tower", lambda self, i, post=None, pre=None: pre)
    with torch.device("meta"):
        cfg = HiFiCodecConfig(**HIFICODEC_PRESETS["hificodec_24k_320d"])
        model = VQVAE.__new__(VQVAE)
        torch.nn.Module.__init__(model)
        model.encoder = HiFiGANEncoder(cfg).to(torch.bfloat16)
        model.generator = HiFiGANGenerator(cfg).to(torch.bfloat16)
    for fused_pre, want in ((False, (98, 2)), (True, (97, 2))):
        model.generator.fused_pre = fused_pre
        with torch.no_grad():
            c, enc_counts = _counts(lambda: model.encoder(torch.empty(16, 1, 240000, device="meta",
                                                                     dtype=torch.bfloat16)))
            q = torch.empty(16, 750, 512, device="meta", dtype=torch.bfloat16)  # the decode's embedded latents
            y, gen_counts = _counts(lambda: model.generator(q.transpose(1, 2)))
        assert c.shape == (16, 512, 750) and y.shape == (16, 1, 240000)
        assert enc_counts == (58, 1)
        assert (enc_counts[0] + gen_counts[0], enc_counts[1] + gen_counts[1]) == want
        assert want == _expected_counts(model, fused_pre)


def _roundtrip(model, wav):
    with torch.no_grad():
        return model.decode(model.encode(wav))


def _int8_model():
    model = VQVAE(HiFiCodecConfig(**CONFIGS["resblock1"]), int8_min_channels=128, device="cpu", dtype=torch.bfloat16)
    return calibrate_quant(model, _wav().to(torch.bfloat16))


BF16 = _wav().to(torch.bfloat16)
CALLS = {  # name: (the model, built outside the counted call; the call)
    "bf16": (lambda: _model("resblock1", torch.bfloat16), lambda m: _roundtrip(m, BF16)),
    "f32": (lambda: _model("resblock1"), lambda m: _roundtrip(m, _wav())),
    "length_masked_encode": (lambda: _model("resblock1", torch.bfloat16),
                             lambda m: m.encode(BF16, lengths=torch.tensor([SAMPLES, 2000]))),
    "int8": (_int8_model, lambda m: _roundtrip(m, BF16)),
    "causal_decode": (lambda: VQVAE(HiFiCodecConfig(**CONFIGS["resblock1"], causal=True), device="cpu",
                                    dtype=torch.bfloat16),
                      lambda m: m.decode(torch.zeros((1, 20, 4), dtype=torch.int32))),
    "encodec": (lambda: SoundStream(n_filters=4, dimension=32, ratios=(4, 4, 2), sample_rate=16000,
                                    target_bandwidths=(1, 2), bins=64, device="cpu", dtype=torch.bfloat16),
                lambda m: m.decode(m.encode(BF16))),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_the_counters_read_zero_off_the_path(monkeypatch, call):
    """The card check patched true: a bf16 HiFi roundtrip counts the config's
    convs and two layout changes; an f32 roundtrip, a length-masked encode,
    an int8 model, a causal generator and an Encodec roundtrip count 0."""
    build, run = CALLS[call]
    model = build()
    monkeypatch.setattr(hifigan, "on_card", lambda x: True)
    _, counts = _counts(lambda: run(model))
    if call == "bf16":
        assert counts == _expected_counts(model) and counts[0] > 0
    else:
        assert counts == (0, 0)
