"""DAC on the card: the Snake epilogue kernel against its plain version, the launches of a
bf16 roundtrip, and the published-width model against its references.

Run on an NVIDIA H100 from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_dac_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which these tests do
not use.) Whether a card is present is decided inside the ``cuda`` fixture;
without one each test skips.
"""

import json

import pytest
import torch

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.ops.cuda import snake as snake_ops
from academicodec_tpu_torch.utils import profiling
from portbench import harness
from dac_reference import DACReference  # tests/ is on the path (pytest puts a test file's directory there)

pytestmark = pytest.mark.cuda
CELL = "dac_44k_512d.roundtrip_fvq_bf16_b16"
# the kernel's sine is the hardware one on an argument reduced to [-pi/2, pi/2]: ~4e-7 from
# torch's, times 1 / alpha (<= 5); 1e-5 of max(1, |y|) leaves that room and no more
F32_TOL = 1e-5
CASES = [(False, False, False), (True, False, True), (True, True, False), (True, True, True)]  # bias, residual, sum


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(C, T, channels_last, dtype, device, seed, pad=0):
    """h (a view of the first ``T`` frames of ``T + pad`` in channels-last), alpha, bias, residual."""
    g = torch.Generator(device=device).manual_seed(seed)
    if channels_last:
        h = (torch.randn(3, T + pad, C, generator=g, device=device) * 30).to(dtype)
        h = h.transpose(1, 2).unsqueeze(2)[..., :T]
        r = (torch.randn(3, T, C, generator=g, device=device) * 3).to(dtype).transpose(1, 2).unsqueeze(2)
    else:
        h = (torch.randn(3, C, T, generator=g, device=device) * 30).to(dtype)
        r = (torch.randn(3, C, T, generator=g, device=device) * 3).to(dtype)
    alpha = 5.0 ** (torch.rand(1, C, 1, generator=g, device=device) * 2 - 1)
    bias = torch.randn(C, generator=g, device=device)
    return h, alpha, bias, r


def _ulps(a, b):
    """bf16 ulps between two bf16 tensors of the same signs (their bit patterns apart)."""
    ai, bi = a.view(torch.int16).int(), b.view(torch.int16).int()
    return (ai - bi).abs().max().item()


@pytest.mark.parametrize("T", [1001, 1024])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("C", [64, 1536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_the_kernel_is_its_plain_version(cuda, dtype, C, channels_last, T):
    """T 1001 (not a multiple of either vector width: one element a thread in [B, C, T])
    and 1024, arguments of hundreds; channels-last from a strided view, y 7 frames longer
    (zeros); f32 within 1e-5 of max(1, |y|), bf16 at most 1 ulp from the plain f32 result
    rounded, f16 too but where y is so near 0 that an f16 ulp is finer than the sine's
    ~4e-7 x 1 / alpha (there within f32's 1e-5), the sum exact."""
    for k, (bias, residual, keep_sum) in enumerate(CASES):
        h, alpha, b, r = _operands(C, T, channels_last, dtype, cuda, 10 * k + C, pad=5 if channels_last else 0)
        b, r = (b if bias else None), (r if residual else None)
        frames = T + 7 if channels_last else None
        before = profiling.total("snake.launches").count
        y, s = snake_ops.snake(h, alpha, b, r, keep_sum, frames)
        torch.cuda.synchronize()
        assert profiling.total("snake.launches").count == before + 1
        f32 = [None if t is None else t.float() for t in (h, r)]
        want, want_s = snake_ops.snake_plain(f32[0], alpha, b, f32[1], keep_sum, frames)
        assert y.dtype == dtype and y.shape == want.shape
        if channels_last:
            assert y.is_contiguous(memory_format=torch.channels_last) and not y[..., T:].any()
        rel = (y.float() - want).abs() / want.abs().clamp(min=1.0)
        if dtype == torch.float32:
            assert rel.max().item() <= F32_TOL
        elif dtype == torch.bfloat16:
            assert _ulps(y, want.to(dtype)) <= 1
        else:
            ulps = (y.view(torch.int16).int() - want.to(dtype).view(torch.int16).int()).abs()
            assert not ((ulps > 1) & (rel > F32_TOL)).any()
        if keep_sum:
            assert torch.equal(s, want_s.to(dtype))
        else:
            assert s is None


def _cell_context(device, dtype, seed=20261019):
    """The cell's set-up (seeded weights and alphas, codebooks spread) on 2 x 1 s clips."""
    traffic = {"batch": 2, "clip_seconds": [1.0, 1.0], "bucket_seconds": 1.0, "batches": 1, "dtype": dtype}
    ctx = harness.make_context(CELL, seed, device, overrides={"traffic": traffic})
    with torch.no_grad():
        ctx.entry.prepare(ctx)
    return ctx


def test_a_bf16_roundtrip_is_58_launches_channels_last(cuda):
    ctx = _cell_context(cuda, "bfloat16")
    model = ctx.state["program"]
    wav = ctx.state["batches"][0][0]
    names = ("snake.launches", "codec.snake", "towers.cl_convs", "snake.elements")
    before = {n: profiling.total(n).count for n in names}
    with torch.no_grad():
        codes = model.encode(wav)
        out = model.decode(codes)
    torch.cuda.synchronize()
    got = {n: profiling.total(n).count - before[n] for n in names}
    convs = sum(1 for name, _ in model.named_modules() if name.startswith(("encoder", "decoder"))
                and type(_).__name__ in ("Conv1d", "ConvTranspose1d"))
    assert got["snake.launches"] == got["codec.snake"] == 58
    assert got["towers.cl_convs"] == convs == 60
    assert codes.shape == (9, 2, 87) and out.shape == (2, 87 * 512) and out.dtype == torch.bfloat16


def test_an_f16_roundtrip_runs_the_kernel(cuda):
    """``load_codec`` in f16: the towers take the channels-last route, as in bf16, with 58
    launches, and the wav is finite."""
    model = load_codec("dac_44k_512d", device=cuda, dtype=torch.float16)
    wav = torch.randn(2, 44100, generator=torch.Generator().manual_seed(1)).mul(0.1).to(cuda)
    before = profiling.total("snake.launches").count
    with torch.no_grad():
        out = model.decode(model.encode(wav))
    torch.cuda.synchronize()
    assert profiling.total("snake.launches").count - before == 58
    assert out.dtype == torch.float16 and bool(torch.isfinite(out).all())


def test_published_model_f32_against_the_reference(cuda):
    """Two 1 s clips in f32: codes as the reference's but at f32 near-ties (1e-2 of them may
    part, a flip moving the row's later residuals), and the decoded wav of the program's
    codes within 1e-3 of the reference's peak (f32 against f32 over 60 convs and 58 Snakes,
    the same operations in another order)."""
    ctx = _cell_context(cuda, "float32")
    model = ctx.state["program"]
    wav = ctx.state["batches"][0][0].to(cuda)
    ref = DACReference(model.state_dict())
    with torch.no_grad():
        codes = model.encode(wav)
        want = ref.encode(wav)
        assert (codes.long() != want).double().mean().item() <= 1e-2
        assert all(len(torch.unique(layer)) > 16 for layer in codes)  # the tokens spread
        out, out_ref = model.decode(codes), ref.decode(codes)
    assert float((out - out_ref).abs().max() / out_ref.abs().max()) <= 1e-3


def test_bf16_roundtrip_against_the_cells_limits(cuda):
    """The cell's set-up, bf16, one call on 2 x 1 s clips: the check's numbers within the cell's limits."""
    ctx = _cell_context(cuda, "bfloat16")
    with torch.no_grad():
        out = ctx.entry.call(ctx, 0)
        ctx.entry.release(ctx)
        checks = ctx.entry.judge(ctx, 0, out)
    limits = json.loads((harness.ROOT / "limits" / f"{CELL}.json").read_text())
    for name, limit in limits.items():
        assert checks[name] <= limit, (name, checks)
