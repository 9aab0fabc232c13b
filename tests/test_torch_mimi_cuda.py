"""Mimi on the card: K1 at Mimi's shapes, and the published-width model against its references.

Run on an NVIDIA H100 from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_mimi_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which these tests do
not use.) Whether a card is present is decided inside the ``cuda`` fixture;
without one each test skips.
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.ops.cuda import rvq as rvq_ops
from academicodec_tpu_torch.utils import profiling
from portbench import compare, harness
from mimi_reference import MimiReference  # tests/ is on the path (pytest puts a test file's directory there)

pytestmark = pytest.mark.cuda
CELL = "mimi_24k_1920d.roundtrip_bf16_b8_20s"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def _excess(x, embed, codes):
    """Following ``codes`` layer by layer, each chosen row's squared distance to the
    residual over the nearest row's, less 1, in the plain f32 arithmetic: the worst."""
    r, worst = x, 0.0
    for book, idx in zip(embed, codes.long()):
        d = r.square().sum(1, keepdim=True) - 2.0 * r @ book.t() + book.square().sum(1)
        best = d.min(dim=1).values
        worst = max(worst, float(((d.gather(1, idx[:, None])[:, 0] - best) / best.abs()).max()))
        r = r - book[idx]
    return worst


@pytest.mark.parametrize("n_q", [1, 31])
def test_k1_at_mimis_shapes(cuda, n_q):
    """[2000, 256] x [n_q, 2048, 256], a call's frames: codes equal the plain version's
    but at f32 near-ties in summation order, whose choice is then within 1e-5 of the
    nearest distance (one flip changes the row's later residuals, so a share of 1e-2
    of the codes may differ)."""
    rng = np.random.default_rng(n_q)
    x, embed = _randn(rng, (2000, 256), cuda), _randn(rng, (n_q, 2048, 256), cuda)
    before = profiling.total("k1.launches").count
    codes = rvq_ops.rvq_encode(x, embed)
    torch.cuda.synchronize()
    assert profiling.total("k1.launches").count == before + 1 and codes.shape == (n_q, 2000)
    plain = rvq_ops.rvq_encode_plain(x, embed)
    assert (codes != plain).double().mean().item() <= 1e-2
    assert torch.equal(codes[0], plain[0]) or (codes[0] != plain[0]).sum() <= 2
    assert _excess(x, embed, codes) <= 1e-5


def _seeded_mimi(device, dtype, seed=0):
    """The published-width Mimi, LayerScales U(-1, 1), codebooks spread over the
    reference's projected latents of two clips."""
    model = load_codec("mimi_24k_1920d", device=device, dtype=torch.float32, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.copy_(torch.rand(p.shape, generator=g, device=device) * 2 - 1)
        z = MimiReference(model.state_dict()).latent(_wavs(2, 12 * 24000, device, seed + 2))
        for part in (model.quantizer.rvq_first, model.quantizer.rvq_rest):
            frames = F.conv1d(z, part.input_proj.weight).transpose(1, 2).reshape(-1, 256)
            pick = lambda: frames[torch.randint(len(frames), (2048,), generator=g, device=device)]  # noqa: E731
            part.vq.embed[0] = pick() + 0.1 * frames.std() * torch.randn(2048, 256, generator=g, device=device)
            for i in range(1, part.vq.num_quantizers):
                part.vq.embed[i] = (pick() - pick()) * 0.25
    return model.to(dtype)


def _wavs(batch, samples, device, seed):
    return torch.randn(batch, samples, generator=torch.Generator(device=device).manual_seed(seed),
                       device=device) * 0.1


def test_published_model_f32_against_the_reference(cuda):
    """Two 12 s clips (300 frames at the transformers: the window binds) in f32:
    the program's codes judged by the reference's distances (a choice may part from
    the reference's only at an f32 near-tie), and the decoded wav of those codes
    within 1e-3 of the reference's peak (f32 against f32 over ~60 layers, the
    same operations in another order)."""
    model = _seeded_mimi(cuda, torch.float32)
    x = _wavs(2, 12 * 24000, cuda, 11)
    codes = model.encode(x)
    assert codes.shape == (32, 2, 150)
    ref = MimiReference(model.state_dict())
    with torch.no_grad():
        want = ref.encode(x)
        assert (codes.long() != want).double().mean().item() <= 1e-2
        gaps = compare.code_gaps(_stacked(ref, x), _chain_books(ref), list(codes.reshape(32, -1, 1)))
        assert gaps["code_gap"] <= 1e-3, gaps
        assert all(len(torch.unique(layer)) > 16 for layer in codes)  # the tokens spread
        wav, wav_ref = model.decode(codes), ref.decode(codes)
    assert wav.shape == x.shape
    assert float((wav - wav_ref).abs().max() / wav_ref.abs().max()) <= 1e-3


def _stacked(ref, x):
    z = ref.latent(x)
    parts = [F.conv1d(z, ref.sd[f"quantizer.{p}.input_proj.weight"]) for p in ("rvq_first", "rvq_rest")]
    y = torch.cat(parts, dim=1)
    return y.transpose(1, 2).reshape(-1, y.shape[1])


def _chain_books(ref):
    zeros = torch.zeros_like(ref.books[0])
    return [torch.cat([ref.books[0], zeros], 1)[None]] + [torch.cat([zeros, b], 1)[None] for b in ref.books[1:]]


def test_bf16_roundtrip_at_the_cells_shape_against_its_limits(cuda):
    """The benchmark cell's set-up (seeded weights, 8 x 20 s clips, bf16), one call:
    the check's numbers within the cell's limits, and the band's pairs a call."""
    ctx = harness.make_context(CELL, 20261018, cuda)
    with torch.no_grad():
        ctx.entry.prepare(ctx)
        profiling.reset("attn.pairs", "attn.pairs_computed")
        out = ctx.entry.call(ctx, 0)
        pairs = profiling.total("attn.pairs").count
        computed = profiling.total("attn.pairs_computed").count
        ctx.entry.release(ctx)
        checks = ctx.entry.judge(ctx, 0, out)
    assert pairs == 8 * 8 * 2 * 93875 == 12_016_000
    assert computed == 8 * 8 * 2 * math.ceil(500 / 64) * 64 * 320
    assert out[0].shape == (32, 8, 250) and out[1].shape == (8, 480000)
    limits = json.loads((harness.ROOT / "limits" / f"{CELL}.json").read_text())
    for name, limit in limits.items():
        assert checks[name] <= limit, (name, checks)
