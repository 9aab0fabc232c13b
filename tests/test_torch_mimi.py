"""The port's Mimi (``models/mimi.py``) against the plain reference ``tests/mimi_reference.py``.

At a tiny width on the CPU, in f32, on one torch thread (the tiny model is
launch-bound, and the suite's workers share the cores): n_filters 4, D 32,
2 transformer layers of 2 heads, a window of 6 frames, 1 + 3 codebooks of
16 x 8, and clips of 150 encoder frames, so that the window binds and the
attention runs in three query blocks.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.models.presets import MIMI_PRESETS
from academicodec_tpu_torch.nn import transformer as tf
from academicodec_tpu_torch.nn.conv import SConvTranspose1d
from academicodec_tpu_torch.utils import profiling
from mimi_reference import MimiReference  # tests/ is on the path (pytest puts a test file's directory there)

TINY = dict(n_filters=4, dimension=32, ratios=(2, 2), sample_rate=200, num_layers=2, num_heads=2, ffn_dim=64,
            context=6, n_q=4, codebook_dim=8, bins=16)
SHAPE = {k: v for k, v in TINY.items() if k != "sample_rate"}
SAMPLES = 600  # 150 frames at the transformers, 75 codes
# f32 against f32: the same operations in another order (blocked attention, cuDNN/oneDNN
# conv algorithms, fused softmax) part in the last bits, ~1e-6 of the signal; 1e-4 of
# the reference's peak leaves that 100x room and is far below what a wrong window or a
# dropped branch moves (the negative tests below: 1e-2 and more)
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, and no autograd: Mimi is served, not trained."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(threads)


def tiny_model(seed=0):
    """A tiny Mimi, LayerScales drawn U(-1, 1) so the transformers move the latents,
    and codebooks spread over the reference's projected latents."""
    model = load_codec("mimi_24k_1920d", device="cpu", seed=seed, **TINY)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale_1.scale") or name.endswith("layer_scale_2.scale"):
                p.copy_(torch.rand(p.shape, generator=g) * 2 - 1)
        ref = MimiReference(model.state_dict(), **SHAPE)
        z = ref.latent(wavs(2, seed + 2))
        for part in (model.quantizer.rvq_first, model.quantizer.rvq_rest):
            frames = F.conv1d(z, part.input_proj.weight).transpose(1, 2).reshape(-1, TINY["codebook_dim"])
            pick = lambda: frames[torch.randint(len(frames), (TINY["bins"],), generator=g)]  # noqa: E731
            part.vq.embed[0] = pick() + 0.1 * frames.std() * torch.randn(pick().shape, generator=g)
            for i in range(1, part.vq.num_quantizers):  # a quarter of the difference of two frames
                part.vq.embed[i] = (pick() - pick()) * 0.25
    return model


def wavs(batch, seed, samples=SAMPLES):
    return torch.randn(batch, samples, generator=torch.Generator().manual_seed(seed)) * 0.1


def reference(model, **over):
    return MimiReference(model.state_dict(), **{**SHAPE, **over})


def err(a, b):
    """The largest difference over the reference's peak."""
    return float((a - b).abs().max() / b.abs().max())


def close(a, b):
    return err(a, b) <= RTOL


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def test_tokens_and_wav_equal_the_reference(model):
    x = wavs(3, 5)
    codes = model.encode(x)
    assert codes.shape == (4, 3, 75) and codes.dtype == torch.int32
    ref = reference(model)
    torch.testing.assert_close(codes.long(), ref.encode(x), rtol=0, atol=0)
    assert all(len(torch.unique(layer)) > 4 for layer in codes)  # the codebooks are in use
    wav = model.decode(codes)
    assert wav.shape == (3, SAMPLES)
    assert close(wav, ref.decode(codes))


def test_each_part_and_the_summed_decode(model):
    ref = reference(model)
    z = ref.latent(wavs(2, 6))
    q = model.quantizer
    for part, books, n in ((q.rvq_first, ref.books[:1], 1), (q.rvq_rest, ref.books[1:], 3)):
        r = ref.projected("rvq_first" if n == 1 else "rvq_rest", z)
        want = []
        for book in books:
            want.append(torch.cdist(r, book).argmin(1))
            r = r - book[want[-1]]
        got = part.encode(z, n).reshape(n, -1).long()
        torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=0)
    codes = q.encode(z)
    assert codes.shape == (4, 2, z.shape[-1])
    assert close(q.decode(codes), ref.dequantize(codes))
    assert close(q.decode(codes[:1]), ref.dequantize(codes[:1]))  # the first part alone
    assert close(q.decode(codes[:3]), ref.dequantize(codes[:3]))  # fewer codebooks than the model has
    torch.testing.assert_close(q.encode(z, 3), codes[:3], rtol=0, atol=0)


@pytest.mark.parametrize("T", [4, 6, 9, 64, 65, 150])
def test_the_transformer_alone_below_at_and_above_the_window(model, T):
    """T below, at and above the 6-frame window, and around the 64-query block."""
    x = torch.randn(2, TINY["dimension"], T, generator=torch.Generator().manual_seed(T))
    got = model.encoder_transformer(x.transpose(1, 2)).transpose(1, 2)
    assert close(got, reference(model).transformer("encoder_transformer", x))


def test_rope_at_a_nonzero_offset():
    """Frames ``o..`` turned at offset ``o`` are the same frames of the whole sequence."""
    x = torch.randn(2, 3, 20, 16, generator=torch.Generator().manual_seed(1))
    whole = tf.apply_rope(x, 0, 10000.0)
    torch.testing.assert_close(tf.apply_rope(x[:, :, 7:], 7, 10000.0), whole[:, :, 7:], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(whole[:, :, 0], x[:, :, 0])  # position 0 is not turned


def test_a_wrong_window_or_a_dropped_layer_scale_is_seen(model):
    """The tolerance tells the reference apart when it ignores the window, or when
    its LayerScales are zero: the tests can see both."""
    x = wavs(2, 7)
    codes = model.encode(x)
    wide = reference(model, context=10_000)
    sd = {k: (torch.zeros_like(v) if k.endswith(".scale") else v) for k, v in model.state_dict().items()}
    no_scale = MimiReference(sd, **SHAPE)
    z = model._encoder_frames(x[:, None, :], None)
    got = model.encoder_transformer(z.transpose(1, 2)).transpose(1, 2)
    for bad in (wide, no_scale):
        assert err(got, bad.transformer("encoder_transformer", z)) > 100 * RTOL
        assert err(model.decode(codes), bad.decode(codes)) > 100 * RTOL
        assert not torch.equal(bad.encode(x), codes.long())


def test_depthwise_conv_transpose():
    conv = SConvTranspose1d(6, 6, 4, stride=2, causal=True, bias=False, norm="none", groups=6)
    conv.convtr.convtr.reset_parameters(torch.Generator().manual_seed(3))
    w = conv.convtr.convtr.weight
    assert w.shape == (6, 1, 4)
    x = torch.randn(2, 6, 11)
    want = F.conv_transpose1d(x, w, stride=2, groups=6)[..., :-2]
    torch.testing.assert_close(conv(x), want)
    bound = 1 / math.sqrt(4)  # torch's fan_in of a depthwise conv-transpose: (out / groups) * k
    assert float(w.abs().max()) <= bound


def test_encode_with_lengths_equals_clips_alone(model):
    lengths = [600, 433, 380, 257]  # 433 and 257 end inside an encoder frame, at an odd frame count
    x = wavs(4, 8)
    x[1, 433:] = 5.0  # garbage past a length changes nothing
    codes = model.encode(x, lengths=lengths)
    for b, n in enumerate(lengths):
        alone = model.encode(x[b:b + 1, :n])
        f = math.ceil(n / model.hop_length)
        torch.testing.assert_close(codes[:, b, :f], alone[:, 0], rtol=0, atol=0)
        assert not codes[:, b, f:].any()


def test_attention_pair_counters(model):
    profiling.reset("attn.pairs", "attn.pairs_computed")
    x = torch.zeros(3, 150, TINY["dimension"])
    model.encoder_transformer(x)
    band = sum(min(t + 1, TINY["context"]) for t in range(150))
    assert tf.band_pairs(150, 6) == band
    assert profiling.total("attn.pairs").count == 3 * 2 * band
    blocks, span = math.ceil(150 / tf.QUERY_BLOCK), math.ceil((tf.QUERY_BLOCK + 5) / tf.KEY_ALIGN) * tf.KEY_ALIGN
    assert profiling.total("attn.pairs_computed").count == 3 * 2 * blocks * tf.QUERY_BLOCK * span


def test_streaming_is_refused(model):
    with pytest.raises(NotImplementedError, match="streaming"):
        model.encode_stream(wavs(1, 1))
    with pytest.raises(NotImplementedError, match="streaming"):
        model.decode_stream(torch.zeros(4, 1, 2, dtype=torch.int32))


def test_the_published_model_has_the_published_parameter_count():
    """Built at every published width on the CPU (not run); parameters counted from
    the config's widths."""
    p = MIMI_PRESETS["mimi_24k_1920d"]
    nf, D, ratios, L, ffn = p["n_filters"], p["dimension"], p["ratios"], p["num_layers"], p["ffn_dim"]

    def conv(cin, cout, k, bias=True):
        return cin * cout * k + (cout if bias else 0)

    def resblock(dim):
        return conv(dim, dim // 2, 3) + conv(dim // 2, dim, 1)

    encoder = conv(1, nf, 7) + conv(nf * 2 ** len(ratios), D, 3)
    decoder = conv(D, nf * 2 ** len(ratios), 7) + conv(nf, 1, 3)
    for i in range(len(ratios)):
        c = nf * 2 ** i
        encoder += resblock(c) + conv(c, 2 * c, 2 * ratios[::-1][i])
        decoder += conv(2 * c, c, 2 * ratios[::-1][i]) + resblock(c)  # the conv-transposes, same count
    layer = 4 * D * D + 2 * D * ffn + 4 * D + 2 * D  # matmuls, two LayerNorms, two LayerScales
    resample = conv(D, D, 4, bias=False) + D * 4  # the downsample, the depthwise upsample
    projections = 2 * 2 * D * p["codebook_dim"]
    model = load_codec("mimi_24k_1920d", device="cpu")
    assert sum(q.numel() for q in model.parameters()) == encoder + decoder + 2 * L * layer + resample + projections
    assert model.quantizer.rvq_rest.vq.embed.shape == (31, 2048, 256)
    assert model.hop_length == 1920 and model.n_q == 32


def test_the_reference_imports_torch_alone():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); import mimi_reference; "
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    tests = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, "-c", code, str(tests)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout))
    assert "torch" in tops and not {"academicodec_tpu_torch", "academicodec_tpu", "jax", "portbench"} & tops
