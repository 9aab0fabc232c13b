"""The port's CUDA kernels against their plain versions, on the card.

Run on an NVIDIA H100 from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which these tests do
not use.) Whether a card is present is decided inside the ``cuda`` fixture,
so every worker collects the same tests; without a card each test skips.
"""

import numpy as np
import pytest
import torch

from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.ops.cuda import lstm as lstm_ops
from academicodec_tpu_torch.ops.cuda import rvq as rvq_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, device, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


@pytest.mark.parametrize(
    "n,d,k,n_q",
    [(75, 32, 64, 2), (300, 100, 200, 4), (257, 512, 1024, 3)],
)
def test_rvq_kernel_matches_plain(cuda, n, d, k, n_q):
    """Ragged N, D not a multiple of the tile, K not a multiple of the chunk:
    tokens equal the plain version's exactly at these sizes."""
    rng = np.random.default_rng(n)
    x, embed = _randn(rng, (n, d), cuda), _randn(rng, (n_q, k, d), cuda)
    before = rvq_ops.LAUNCHES
    codes = rvq_ops.rvq_encode(x, embed)
    torch.cuda.synchronize()
    assert rvq_ops.LAUNCHES == before + 1
    assert codes.dtype == torch.int32 and codes.shape == (n_q, n)
    torch.testing.assert_close(codes, rvq_ops.rvq_encode_plain(x, embed), rtol=0, atol=0)


@pytest.mark.parametrize(
    "wdt,odt,B,T,H,atol",
    [
        # f32 weights: the f32 scan's function; only summation order differs
        (torch.float32, torch.float32, 2, 70, 64, 1e-4),
        (torch.float32, torch.float32, 10, 20, 98, 1e-4),  # B > 8, H not a multiple of 4
        # bf16 weights: h is rounded to bf16 each step, so an order-of-summation
        # difference can flip one rounding and carry a bf16 ulp forward
        (torch.bfloat16, torch.bfloat16, 8, 50, 512, 1e-2),
        (torch.bfloat16, torch.float32, 3, 33, 96, 1e-2),
    ],
)
def test_lstm2_kernel_matches_plain(cuda, wdt, odt, B, T, H, atol):
    rng = np.random.default_rng(H)
    x_proj = _randn(rng, (T, B, 4 * H), cuda, 0.5)
    ws = [_randn(rng, (4 * H, H), cuda, H ** -0.5).to(wdt) for _ in range(3)]
    b2 = _randn(rng, (4 * H,), cuda, 0.1)
    before = lstm_ops.LAUNCHES
    y = lstm_ops.lstm2(x_proj, *ws, b2, out_dtype=odt)
    torch.cuda.synchronize()
    assert lstm_ops.LAUNCHES == before + 1
    assert y.dtype == odt and y.shape == (T, B, H)
    ref = lstm_ops.lstm2_plain(x_proj, *ws, b2, out_dtype=odt)
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=atol)


def test_soundstream_cuda_matches_cpu(cuda):
    """The tiny f32 model on the card (both kernels) against the same model on
    the CPU (plain versions): identical tokens, and the same wav from them."""
    kw = dict(n_filters=4, dimension=32, ratios=(6, 5, 4, 2), target_bandwidths=(1, 2, 4, 8, 12))
    on_gpu, on_cpu = SoundStream(device=cuda, **kw), SoundStream(device="cpu", **kw)
    wav = torch.from_numpy(
        (np.random.default_rng(3).standard_normal((2, 4800)) * 0.1).astype(np.float32)
    )
    k1, k2 = rvq_ops.LAUNCHES, lstm_ops.LAUNCHES
    codes = on_gpu.encode(wav)
    out = on_gpu.decode(codes)
    torch.cuda.synchronize()
    assert (rvq_ops.LAUNCHES - k1, lstm_ops.LAUNCHES - k2) == (1, 2)
    codes_cpu = on_cpu.encode(wav)
    torch.testing.assert_close(codes.cpu(), codes_cpu, rtol=0, atol=0)
    torch.testing.assert_close(out.cpu(), on_cpu.decode(codes_cpu), atol=1e-4, rtol=1e-3)
