"""The port's DAC (``models/dac.py``) against the plain reference ``tests/dac_reference.py``.

At a tiny width on the CPU, in f32, on one torch thread (the tiny model is
launch-bound, and the suite's workers share the cores): encoder 4 channels
at strides (2, 2), a 16-wide latent, decoder 16 channels at rates (2, 2), 3
codebooks of 16 x 4, and clips that are not a multiple of the hop, so that
the right padding is exercised. Snake alphas are drawn per channel,
log-uniform on [0.2, 5]: with every alpha at DAC's init 1, a wrong channel
index or a dropped ``1 / alpha`` would not show.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.models.presets import DAC_PRESETS
from academicodec_tpu_torch.nn import dac as dac_nn
from academicodec_tpu_torch.ops.cuda import snake as snake_ops
from academicodec_tpu_torch.utils import profiling
from dac_reference import DACReference, snake  # tests/ is on the path (pytest puts a test file's directory there)

TINY = dict(encoder_dim=4, encoder_rates=(2, 2), latent_dim=16, decoder_dim=16, decoder_rates=(2, 2),
            n_codebooks=3, codebook_size=16, codebook_dim=4, sample_rate=400)
SHAPE = {k: v for k, v in TINY.items() if k != "sample_rate"}
SAMPLES = 403  # 101 frames of 4 samples, the last one padded
# f32 against f32: the same operations in another order (the bias added after the conv, not
# inside it; oneDNN conv algorithms) part in the last bits, ~1e-6 of the signal. The port's
# parity contract, atol 1e-4 / rtol 1e-3, leaves that 100x room; a wrong alpha, bias or
# residual moves the wav by 1e-2 and more
ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, and no autograd: DAC is served, not trained."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(threads)


def tiny_model(seed=0):
    """A tiny DAC, its Snake alphas drawn log-uniform on [0.2, 5] from the seed, and each
    layer's codebook spread over that layer's normalized projections of the reference's
    residuals on two clips (the latents of random-weight towers are mostly their mean,
    so N(0, 1) rows would take one token)."""
    model = load_codec("dac_44k_512d", device="cpu", seed=seed, **TINY)
    g = torch.Generator().manual_seed(seed + 1)
    for name, p in model.named_parameters():
        if name.endswith(".alpha"):
            p.copy_(5.0 ** (torch.rand(p.shape, generator=g) * 2 - 1))
    ref = DACReference(model.state_dict(), **SHAPE)
    r = ref.encoder(wavs(2, seed + 2)).transpose(1, 2).reshape(-1, TINY["latent_dim"])
    for i, q in enumerate(model.quantizer.quantizers):
        p = F.normalize(ref.proj(f"quantizer.quantizers.{i}.in_proj", r))
        pick = torch.randint(p.shape[0], (TINY["codebook_size"],), generator=g)
        book = p[pick] + 0.1 * p.std() * torch.randn(p[pick].shape, generator=g)
        q.codebook.weight.copy_(book)
        r = r - ref.proj(f"quantizer.quantizers.{i}.out_proj", book[(p @ F.normalize(book).t()).argmax(1)])
    return model


def wavs(batch, seed, samples=SAMPLES):
    return torch.randn(batch, samples, generator=torch.Generator().manual_seed(seed)) * 0.1


def test_the_port_is_the_reference():
    """Codes identical, at every layer count, and the decoded wav within the parity contract."""
    model = tiny_model()
    ref = DACReference(model.state_dict(), **SHAPE)
    x = wavs(2, 3)
    codes = model.encode(x)
    assert codes.shape == (3, 2, 101) and codes.dtype == torch.int32
    expected = ref.encode(x)
    assert torch.equal(codes.long(), expected)
    assert all(len(torch.unique(layer)) > 4 for layer in codes)  # the search does real work
    assert torch.equal(model.encode(x, n_q=2).long(), expected[:2])
    wav = model.decode(codes)
    assert wav.shape == (2, 404)
    torch.testing.assert_close(wav, ref.decode(expected), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(model.decode(codes[:1]), ref.decode(expected[:1]), atol=ATOL, rtol=RTOL)


def test_the_channels_last_route_is_the_plain_route():
    """The towers' 4-D route (on the card in 16-bit) run here in f32 on ``[B, C, 1, T]``:
    the epilogues' zero-padded frames in front of each dilated conv, run as its phases,
    and the strided views of the conv's first ``T`` frames give the 3-D route's numbers."""
    model = tiny_model(1)
    x = F.pad(wavs(2, 4), (0, 1))  # 404 samples: 101 frames
    cl_before = profiling.total("towers.cl_convs").count
    z3 = model.encoder(x[:, None, :])
    z4 = model.encoder(dac_nn.wav_channels_last(x))
    assert z4.shape == (2, 16, 1, 101)
    torch.testing.assert_close(z4[:, :, 0], z3, atol=1e-5, rtol=1e-5)
    w3 = model.decoder(z3)
    w4 = model.decoder(z3.unsqueeze(2))
    torch.testing.assert_close(w4.reshape(w3.shape), w3, atol=1e-5, rtol=1e-5)
    convs = sum(isinstance(m, (dac_nn.Conv1d, dac_nn.ConvTranspose1d)) for m in (*model.encoder.modules(),
                                                                                 *model.decoder.modules()))
    assert profiling.total("towers.cl_convs").count - cl_before == convs


@pytest.mark.parametrize("bias,residual,keep_sum", [(False, False, False), (True, False, True),
                                                    (True, True, False), (True, True, True)])
def test_the_plain_epilogue_is_the_references_snake(bias, residual, keep_sum):
    g = torch.Generator().manual_seed(5)
    h = torch.randn(2, 6, 37, generator=g) * 30  # arguments of hundreds, as random-weight towers give
    alpha = 5.0 ** (torch.rand(1, 6, 1, generator=g) * 2 - 1)
    b = torch.randn(6, generator=g) if bias else None
    r = torch.randn(2, 6, 37, generator=g) if residual else None
    y, s = snake_ops.snake_plain(h, alpha, b, r, keep_sum)
    x = h + (b[None, :, None] if bias else 0) + (r if residual else 0)
    torch.testing.assert_close(y, snake(x, alpha), atol=1e-6, rtol=1e-6)
    assert (s is None) == (not keep_sum) and (s is None or torch.equal(s, x))
    # the channels-last layout, y given 3 more frames, written as zeros
    y4, _ = snake_ops.snake_plain(h.unsqueeze(2), alpha, b, None if r is None else r.unsqueeze(2), frames=40)
    assert y4.shape == (2, 6, 1, 40) and not y4[..., 37:].any()
    torch.testing.assert_close(y4[:, :, 0, :37], y)
    assert torch.equal(snake_ops.snake(h, alpha, b, r, keep_sum)[0], y)  # CPU tensors: the plain version


def _snake_elements(B, samples, p=DAC_PRESETS["dac_44k_512d"]):
    """Elements through a roundtrip's 58 Snakes, from the published structure."""
    T, C, n = -(-samples // 512) * 512, p["encoder_dim"], 0
    for s in p["encoder_rates"]:
        n += 7 * B * C * T  # 3 residual units of two Snakes, and the block's
        T, C = T // s, 2 * C
    n += B * C * T
    C = p["decoder_dim"]
    for s in p["decoder_rates"]:
        n += B * C * T
        T, C = T * s, C // 2
        n += 6 * B * C * T
    return n + B * C * T


def test_the_published_config_on_the_meta_device():
    """58 epilogues a roundtrip (29 each way), 862 frames for 10 s at 44.1 kHz, and the
    elements through the Snakes counted from host shapes: 20.8 G for 16 clips."""
    model = load_codec("dac_44k_512d", device="meta")
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(76e6, rel=0.02)
    assert model.frames_for(441000) == 862 and model.hop_length == 512
    before = profiling.totals()
    codes = model.encode(torch.empty(16, 441000, device="meta"))
    assert codes.shape == (9, 16, 862)
    mid = profiling.totals()
    wav = model.decode(codes)
    assert wav.shape == (16, 862 * 512)
    after = profiling.totals()

    def delta(a, b, name):
        return b.get(name, profiling.Total(0, 0)).count - a.get(name, profiling.Total(0, 0)).count

    assert delta(before, mid, "codec.snake") == 29 and delta(mid, after, "codec.snake") == 29
    assert delta(before, after, "snake.elements") == _snake_elements(16, 441000)
    assert 20.7e9 < _snake_elements(16, 441000) < 20.9e9
    assert delta(before, after, "snake.launches") == 0  # no kernel off the card


def test_what_is_not_served_says_so():
    model = tiny_model()
    with pytest.raises(NotImplementedError, match="length-masked"):
        model.encode(wavs(2, 0), lengths=[403, 300])
    with pytest.raises(NotImplementedError, match="streaming encode"):
        model.encode_stream(wavs(1, 0))
    with pytest.raises(NotImplementedError, match="streaming decode"):
        model.decode_stream(torch.zeros(3, 1, 4, dtype=torch.long))


def test_the_f32_parts_stay_f32():
    """In bf16 the towers' weights turn bf16; alphas, the epilogues' biases and the quantizer stay f32."""
    model = load_codec("dac_44k_512d", device="cpu", dtype=torch.bfloat16, **TINY)
    assert model.dtype == torch.bfloat16 and model.encoder.block[0].weight_v.dtype == torch.bfloat16
    assert all(m.alpha.dtype == torch.float32 for m in model.modules() if isinstance(m, dac_nn.Snake1d))
    assert all(c.bias.dtype == torch.float32 for c in dac_nn.epilogue_convs(model))
    assert model.encoder.block[-1].bias.dtype == torch.bfloat16  # the latent conv adds its own
    assert all(p.dtype == torch.float32 for p in model.quantizer.parameters())
    assert math.isclose(model.frame_rate, 100.0)


def test_chip_smoke_snake_phase_rehearsal():
    """``chip_smoke.phase_snake`` at the tiny width on the CPU: the plain versions run (no
    launch counted), and every one of the 30 epilogue calls is held against ``snake_plain``."""
    import chip_smoke

    res = chip_smoke.phase_snake("cpu", batch=2, seconds=SAMPLES / TINY["sample_rate"], dtypes=(torch.float32,),
                                 **TINY)
    assert res["launches"] == 0
    assert res["float32"]["calls"] == 30 and res["float32"]["max_rel"] == 0.0
