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

from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES
from academicodec_tpu_torch.ops.cuda import lstm as lstm_ops
from academicodec_tpu_torch.ops.cuda import resblock as rb_ops
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
    [
        (75, 32, 64, 2),
        (300, 100, 200, 4),
        (257, 512, 1024, 3),
        (10, 512, 1024, 3),  # N smaller than one 64-row block tile
        (100, 64, 300, 1),   # n_q 1
        (90, 30, 100, 2),    # D % 4 != 0: 4-byte copies into the ring
    ],
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


def test_rvq_kernel_flagship_shape(cuda):
    """[8000, 512] x [12, 1024, 512]: f32 near-ties in summation order are the
    only allowed cause of a token mismatch, held to 1e-4."""
    rng = np.random.default_rng(8000)
    x, embed = _randn(rng, (8000, 512), cuda), _randn(rng, (12, 1024, 512), cuda)
    codes = rvq_ops.rvq_encode(x, embed)
    mismatch = (codes != rvq_ops.rvq_encode_plain(x, embed)).double().mean().item()
    assert mismatch <= 1e-4


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
        (torch.bfloat16, torch.bfloat16, 8, 1000, 512, 1e-2),  # the flagship call
        (torch.bfloat16, torch.bfloat16, 4, 1, 512, 1e-2),     # T 1: one step of each layer
        (torch.float32, torch.float32, 5, 1, 64, 1e-4),
        (torch.bfloat16, torch.bfloat16, 8, 30, 600, 1e-2),    # 150 units of 4 > 132 SMs: 8 a block
        (torch.float32, torch.float32, 3, 12, 536, 1e-4),      # f32: 134 blocks of 4 > 132 SMs
        # the trainer's no-grad regenerate of 16 x 1 s: B 16 takes two MMA column
        # tiles; f32 as the f32 step, bf16 weights as mixed precision
        (torch.float32, torch.float32, 16, 100, 512, 1e-4),
        (torch.bfloat16, torch.bfloat16, 16, 100, 512, 1e-2),
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


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32])
def test_lstm2_widest_batch(cuda, wdt):
    """The widest B whose block fits in shared memory at H 512 runs and agrees;
    one more raises instead of falling back."""
    H, T = 512, 9
    itemsize = torch.empty((), dtype=wdt).element_size()
    B = max(b for b in range(1, 512) if lstm_ops.lstm2_smem_bytes(4, b, H, itemsize) <= MAX_SMEM_BYTES)
    rng = np.random.default_rng(B)
    x_proj = _randn(rng, (T, B, 4 * H), cuda, 0.5)
    ws = [_randn(rng, (4 * H, H), cuda, H ** -0.5).to(wdt) for _ in range(3)]
    b2 = _randn(rng, (4 * H,), cuda, 0.1)
    y = lstm_ops.lstm2(x_proj, *ws, b2, out_dtype=wdt)
    ref = lstm_ops.lstm2_plain(x_proj, *ws, b2, out_dtype=wdt)
    tol = 1e-2 if wdt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)
    wider = _randn(rng, (T, B + 8, 4 * H), cuda, 0.5)
    with pytest.raises(RuntimeError, match="shared memory"):
        lstm_ops.lstm2(wider, *ws, b2, out_dtype=wdt)


def test_lstm2_geometry_on_this_card(cuda):
    """At H 600 the 150 blocks of 4 units would outnumber the SMs, so a block
    owns more units; the flagship H 512 keeps 4 units a block on an H100."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    jb, blocks, _ = lstm_ops.lstm2_geometry(8, 600, 2, sms)
    assert jb > 4 and blocks < 150 and blocks <= sms
    if sms >= 128:
        assert lstm_ops.lstm2_geometry(8, 512, 2, sms)[:2] == (4, 128)


def _lstm2_case(rng, wdt, B, T, H, device):
    x_proj = _randn(rng, (T, B, 4 * H), device, 0.5)
    ws = [_randn(rng, (4 * H, H), device, H ** -0.5).to(wdt) for _ in range(3)]
    return x_proj, ws, _randn(rng, (4 * H,), device, 0.1)


@pytest.mark.parametrize(
    "wdt,B,T,H,atol",
    [
        (torch.bfloat16, 8, 10, 512, 1e-2),   # a streaming chunk of the flagship
        (torch.bfloat16, 3, 33, 96, 1e-2),
        (torch.float32, 2, 70, 64, 1e-4),
        (torch.float32, 3, 12, 536, 1e-4),    # 134 blocks of 4 > 132 SMs
        (torch.bfloat16, 8, 30, 600, 1e-2),   # 8 units a block
    ],
)
def test_lstm2_kernel_carry_matches_plain(cuda, wdt, B, T, H, atol):
    """With a random initial carry, the output and the final (h1, c1, h2, c2)
    agree with the plain version's; one launch per call."""
    rng = np.random.default_rng(T + H)
    x_proj, ws, b2 = _lstm2_case(rng, wdt, B, T, H, cuda)
    carry = tuple(_randn(rng, (B, H), cuda, 0.5) for _ in range(4))
    before = lstm_ops.LAUNCHES
    y, final = lstm_ops.lstm2(x_proj, *ws, b2, out_dtype=wdt, carry=carry, return_carry=True)
    torch.cuda.synchronize()
    assert lstm_ops.LAUNCHES == before + 1
    ref, ref_final = lstm_ops.lstm2_plain(x_proj, *ws, b2, out_dtype=wdt, carry=carry, return_carry=True)
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=atol)
    for a, b in zip(final, ref_final):
        assert a.dtype == torch.float32 and a.shape == (B, H)
        torch.testing.assert_close(a, b, atol=atol, rtol=atol)


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,H,split",
    [
        (8, 512, (10,) * 100),  # the flagship's T 1000 as 100 streaming chunks
        (8, 512, (7, 3)),       # ragged
        (8, 512, (1,)),         # T 1
        (3, 96, (1, 1, 5, 2)),
        (3, 536, (4, 6)),       # 134 blocks of 4 > 132 SMs: 8 units a block
    ],
)
def test_lstm2_kernel_split_calls_equal_one_call(cuda, wdt, B, H, split):
    """One call over T equals, bitwise, calls over pieces of T that pass the
    carry along: a step's arithmetic does not depend on T, and the carried
    f32 h rounds on load to the value the exchange buffer would hold."""
    T = sum(split)
    rng = np.random.default_rng(T)
    x_proj, ws, b2 = _lstm2_case(rng, wdt, B, T, H, cuda)
    carry0 = tuple(_randn(rng, (B, H), cuda, 0.5) for _ in range(4))
    for start in (None, carry0):
        y, final = lstm_ops.lstm2(x_proj, *ws, b2, out_dtype=wdt, carry=start, return_carry=True)
        ys, carry, t = [], start, 0
        for n in split:
            piece, carry = lstm_ops.lstm2(x_proj[t:t + n], *ws, b2, out_dtype=wdt, carry=carry, return_carry=True)
            ys.append(piece)
            t += n
        assert torch.equal(torch.cat(ys), y)
        assert all(torch.equal(a, b) for a, b in zip(carry, final))
    # the old call without a carry equals the zero carry
    zeros = tuple(torch.zeros((B, H), device=cuda) for _ in range(4))
    assert torch.equal(lstm_ops.lstm2(x_proj, *ws, b2, out_dtype=wdt),
                       lstm_ops.lstm2(x_proj, *ws, b2, out_dtype=wdt, carry=zeros))


def test_lstm2_empty_sequence_launches_nothing(cuda):
    H = 64
    ws = [torch.zeros((4 * H, H), device=cuda) for _ in range(3)]
    before = lstm_ops.LAUNCHES
    y = lstm_ops.lstm2(torch.zeros((0, 2, 4 * H), device=cuda), *ws, torch.zeros(4 * H, device=cuda),
                       out_dtype=torch.float32)
    assert y.shape == (0, 2, H) and lstm_ops.LAUNCHES == before


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


RB1 = ("1", (3, 7, 11), ((1, 3, 5),) * 3)
RB2 = ("2", (3, 7), ((1, 3), (1, 3)))


def _tower(rng, C, ks, dss, resblock, device, dtype):
    weights, biases = [], []
    for k, ds in zip(ks, dss):
        n = len(rb_ops.chain_conv_dilations(ds, resblock))
        weights.append([_randn(rng, (C, C, k), device, 0.5 / np.sqrt(C * k)).to(dtype) for _ in range(n)])
        biases.append([_randn(rng, (C,), device, 0.1).to(dtype) for _ in range(n)])
    return weights, biases


def _tol(dtype, ref, f32_atol):
    # bf16: the same rounding points; f32 summation order can flip a bf16
    # rounding inside a chain, so the bound scales with |ref|
    return 2e-2 * ref.abs().max().item() if dtype == torch.bfloat16 else f32_atol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rbk", [RB1, RB2], ids=["resblock1", "resblock2"])
@pytest.mark.parametrize(
    "B,C,T,post",
    [
        (2, 64, 1000, False),  # several tiles, T not a multiple of the tile
        (1, 32, 777, True),    # two-strip tiles, conv_post + tanh
        (3, 16, 45, True),     # T below the halo: every output sees both edges
        (2, 64, 130, False),   # exactly one tile
        (2, 24, 300, False),   # C % 16 != 0: bf16 takes the FMA path
        (2, 48, 300, False),   # bf16: not a width of the tensor-core path, so the FMA path
        (1, 96, 500, True),    # bf16: likewise, with the post conv
    ],
)
def test_resblock_tower_kernel_matches_plain(cuda, dtype, rbk, B, C, T, post):
    resblock, ks, dss = rbk
    rng = np.random.default_rng(C + T)
    weights, biases = _tower(rng, C, ks, dss, resblock, cuda, dtype)
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock=resblock)
    if post:
        kw.update(post_weight=_randn(rng, (1, C, 7), cuda, 0.5 / np.sqrt(C * 7)).to(dtype),
                  post_bias=_randn(rng, (1,), cuda, 0.1).to(dtype), post_tanh=True)
    x = _randn(rng, (B, C, T), cuda, 0.5).to(dtype)
    before = rb_ops.TOWER_LAUNCHES
    y = rb_ops.resblock_tower(x, weights, biases, **kw)
    torch.cuda.synchronize()
    assert rb_ops.TOWER_LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == (B, 1 if post else C, T)
    ref = rb_ops.resblock_tower_plain(x, weights, biases, **kw).float()
    torch.testing.assert_close(y.float(), ref, atol=_tol(dtype, ref, 1e-4), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "ks,dss,C,T",
    [
        ((3, 7), ((1, 3), (1, 3)), 32, 575),
        ((11, 7, 3), ((1, 3, 5),) * 3, 64, 1100),
        ((11, 7, 3), ((1, 3, 5),) * 3, 32, 50),
        ((11, 7, 3), ((1, 3, 5),) * 3, 128, 333),  # bf16: the FMA path; f32: a 16-column tile
    ],
)
def test_resblock_tower_gn_kernel_matches_plain(cuda, dtype, ks, dss, C, T):
    rng = np.random.default_rng(T)
    G = len(ks)
    weights, biases = _tower(rng, C, ks, dss, "1", cuda, dtype)
    scs = (_randn(rng, (G, C), cuda, 0.3) + 1.0).to(dtype)
    gbs = _randn(rng, (G, C), cuda, 0.1).to(dtype)
    x = _randn(rng, (2, C, T), cuda, 0.5).to(dtype)
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock="1", num_groups=C // 16)
    before = rb_ops.GN_TOWER_LAUNCHES
    y = rb_ops.resblock_tower_gn(x, weights, biases, scs, gbs, **kw)
    torch.cuda.synchronize()
    assert rb_ops.GN_TOWER_LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    ref = rb_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, **kw).float()
    # bf16: the JAX package's tolerance for this bundle
    torch.testing.assert_close(y.float(), ref, atol=5e-2 if dtype == torch.bfloat16 else 1e-4, rtol=0)


def _k3_case(cuda, dtype, rbk, B, C, T, post=False, post_tanh=True, seed=None):
    """One K3 call against its plain version; returns the kernel's output."""
    resblock, ks, dss = rbk
    rng = np.random.default_rng(C + T if seed is None else seed)
    weights, biases = _tower(rng, C, ks, dss, resblock, cuda, dtype)
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock=resblock)
    if post:
        kw.update(post_weight=_randn(rng, (1, C, 7), cuda, 0.5 / np.sqrt(C * 7)).to(dtype),
                  post_bias=_randn(rng, (1,), cuda, 0.1).to(dtype), post_tanh=post_tanh)
    x = _randn(rng, (B, C, T), cuda, 0.5).to(dtype)
    before = rb_ops.TOWER_LAUNCHES
    y = rb_ops.resblock_tower(x, weights, biases, **kw)
    torch.cuda.synchronize()
    assert rb_ops.TOWER_LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == (B, 1 if post else C, T)
    ref = rb_ops.resblock_tower_plain(x, weights, biases, **kw).float()
    torch.testing.assert_close(y.float(), ref, atol=_tol(dtype, ref, 1e-4), rtol=0)
    return y


def _tc_tile(C, rbk, post, gn=False):
    resblock, ks, dss = rbk
    return rb_ops.pick_tile_tc(C, ks, dss, resblock, 3 if post else 0, gn).TT


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("edge", ["TT-1", "TT", "TT+1", "2TT+1"])
def test_resblock_tower_at_tile_edges(cuda, C, edge):
    """bf16 tensor-core path with T just below, at and just above one tile, and
    one past two tiles: the ragged last tile and its zero edge."""
    post = C == 32
    tt = _tc_tile(C, RB1, post)
    T = {"TT-1": tt - 1, "TT": tt, "TT+1": tt + 1, "2TT+1": 2 * tt + 1}[edge]
    _k3_case(cuda, torch.bfloat16, RB1, 2, C, T, post=post)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,B", [(1, 16, 1), (1, 64, 1), (7, 32, 1), (59, 64, 1), (59, 16, 2)])
def test_resblock_tower_below_one_halo(cuda, dtype, T, C, B):
    """T of one sample and T below the 60-sample halo, batch 1 included."""
    _k3_case(cuda, dtype, RB1, B, C, T, post=T == 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rbk", [RB1, RB2], ids=["resblock1", "resblock2"])
@pytest.mark.parametrize("C", [16, 32, 64])
def test_resblock_tower_post_without_tanh(cuda, dtype, rbk, C):
    _k3_case(cuda, dtype, rbk, 1, C, 400, post=True, post_tanh=False)


@pytest.mark.parametrize("C", [8, 48])
@pytest.mark.parametrize("rbk", [RB1, RB2], ids=["resblock1", "resblock2"])
def test_resblock_tower_bf16_fma_widths(cuda, C, rbk):
    """bf16 at widths the tensor-core path does not take runs the FMA path."""
    assert not rb_ops.uses_tc(torch.bfloat16, C)
    _k3_case(cuda, torch.bfloat16, rbk, 2, C, 333, post=C == 8)


@pytest.mark.parametrize("tag,C,T,post", [("s2", 64, 120000, False), ("s3", 32, 240000, True)])
def test_resblock_tower_flagship_shapes(cuda, tag, C, T, post):
    """The generator stages of hificodec_24k_320d at batch 8 x 10 s, twice: the
    same bits both times."""
    y0 = _k3_case(cuda, torch.bfloat16, RB1, 8, C, T, post=post, seed=1)
    y1 = _k3_case(cuda, torch.bfloat16, RB1, 8, C, T, post=post, seed=1)
    assert torch.equal(y0, y1)


def test_resblock_tower_packed_operands(cuda):
    """Operands packed once give the bits of a call that packs on the spot,
    and a packed tower refuses an input of another dtype or width."""
    resblock, ks, dss = RB1
    rng = np.random.default_rng(9)
    weights, biases = _tower(rng, 64, ks, dss, resblock, cuda, torch.bfloat16)
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock=resblock)
    packed = rb_ops.pack_tower(weights, biases, **kw)
    assert packed.tc and packed.w_all.dtype == torch.bfloat16
    assert torch.equal(rb_ops.unpack_taps(packed.w_all[: 64 * 64 * 3], 64, 3), weights[0][0])
    x = _randn(rng, (2, 64, 500), cuda, 0.5).to(torch.bfloat16)
    assert torch.equal(rb_ops.resblock_tower(x, packed), rb_ops.resblock_tower(x, weights, biases, **kw))
    with pytest.raises(ValueError, match="packed as"):
        rb_ops.resblock_tower(x.float(), packed)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rb_ops.resblock_tower(x.cpu(), packed)


def _k4_inputs(cuda, dtype, ks, dss, B, C, T, seed):
    rng = np.random.default_rng(seed)
    G = len(ks)
    weights, biases = _tower(rng, C, ks, dss, "1", cuda, dtype)
    scs = (_randn(rng, (G, C), cuda, 0.3) + 1.0).to(dtype)
    gbs = _randn(rng, (G, C), cuda, 0.1).to(dtype)
    x = _randn(rng, (B, C, T), cuda, 0.5).to(dtype)
    return x, weights, biases, scs, gbs, dict(kernel_sizes=ks, dilation_sizes=dss, resblock="1")


RB1_ENC = ("1", (11, 7, 3), ((1, 3, 5),) * 3)


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("edge", ["1", "below halo", "TT-1", "TT", "TT+1", "2TT+1"])
def test_resblock_tower_gn_at_tile_edges(cuda, C, edge):
    """K4 in bf16 on the tensor-core path at the tile edges, T 1 and T below
    the halo; batch 1 at C 16."""
    tt = _tc_tile(C, RB1_ENC, False, gn=True)
    T = {"1": 1, "below halo": 41, "TT-1": tt - 1, "TT": tt, "TT+1": tt + 1, "2TT+1": 2 * tt + 1}[edge]
    x, weights, biases, scs, gbs, kw = _k4_inputs(cuda, torch.bfloat16, RB1_ENC[1], RB1_ENC[2],
                                                   1 if C == 16 else 2, C, T, seed=T)
    y = rb_ops.resblock_tower_gn(x, weights, biases, scs, gbs, num_groups=C // 16, **kw)
    torch.cuda.synchronize()
    ref = rb_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, num_groups=C // 16, **kw).float()
    # T 1: a group's variance over 16 values of one sample each; the plain
    # version and the kernel differ by the rounding of single chain outputs
    torch.testing.assert_close(y.float(), ref, atol=5e-2, rtol=0)


@pytest.mark.parametrize("dtype,B,C,T", [(torch.bfloat16, 8, 64, 120000), (torch.bfloat16, 2, 32, 1001),
                                         (torch.float32, 2, 32, 575)])
def test_resblock_tower_gn_is_reproducible(cuda, dtype, B, C, T):
    """The encoder's stage 0 shape (and two small ones): chain outputs, moments
    and the output are the same bits in two calls (fixed-order sums, no
    atomics), and the whole agrees with the plain version."""
    x, weights, biases, scs, gbs, kw = _k4_inputs(cuda, dtype, RB1_ENC[1], RB1_ENC[2], B, C, T, seed=3)
    packed = rb_ops.pack_tower(weights, biases, **kw)
    outs0, mom0 = rb_ops.gn_tower_chains(x, packed)
    outs1, mom1 = rb_ops.gn_tower_chains(x, packed)
    assert torch.equal(outs0, outs1) and torch.equal(mom0, mom1)
    torch.testing.assert_close(mom0, rb_ops.moments(list(outs0)), rtol=1e-4, atol=1e-2)
    y0 = rb_ops.resblock_tower_gn(x, packed, None, scs, gbs, num_groups=C // 16)
    y1 = rb_ops.resblock_tower_gn(x, weights, biases, scs, gbs, num_groups=C // 16, **kw)
    assert torch.equal(y0, y1)
    ref = rb_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, num_groups=C // 16, **kw).float()
    torch.testing.assert_close(y0.float(), ref, atol=5e-2 if dtype == torch.bfloat16 else 1e-4, rtol=0)


@pytest.mark.parametrize("G,B,C,T,groups", [(3, 8, 64, 120000, 4), (2, 3, 32, 575, 2), (1, 1, 16, 9, 1),
                                            (4, 2, 128, 300, 8)])
def test_gn_affine_kernel_matches_plain(cuda, G, B, C, T, groups):
    """``gn_affine_kernel`` against ``gn_affines`` on moments of random chain
    outputs: f32, every operation rounded as in the plain version, group sums
    in channel order."""
    rng = np.random.default_rng(G + C)
    rs = [_randn(rng, (B, C, min(T, 2000)), cuda, 0.7) for _ in range(G)]
    mom = rb_ops.moments(rs) * (T / min(T, 2000))
    scs, gbs = _randn(rng, (G, C), cuda, 0.3) + 1.0, _randn(rng, (G, C), cuda, 0.1)
    A, K = rb_ops.gn_affines_cuda(mom, scs, gbs, groups, 1e-6, T)
    A_ref, K_ref = rb_ops.gn_affines(mom, scs, gbs, groups, 1e-6, T)
    torch.testing.assert_close(A, A_ref, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(K, K_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,B,C,T", [(3, 2, 64, 4096), (2, 3, 16, 575), (1, 1, 8, 1), (4, 1, 32, 8)])
def test_gn_apply_kernel_matches_plain(cuda, dtype, G, B, C, T):
    """``gn_apply_kernel`` (16-byte loads where T allows, scalar otherwise)
    against ``gn_apply``: the same f32 operations, so the same bits."""
    rng = np.random.default_rng(T)
    rs = _randn(rng, (G, B, C, T), cuda, 0.7).to(dtype)
    A, K = _randn(rng, (G, B, C), cuda, 1.0), _randn(rng, (B, C), cuda, 0.5)
    y = rb_ops.gn_apply_cuda(rs, A, K)
    assert y.dtype == dtype and y.shape == (B, C, T)
    assert torch.equal(y, rb_ops.gn_apply(list(rs), A, K))


def test_vqvae_cuda_matches_cpu(cuda):
    """A tiny f32 HiFi-Codec on the card (K3 twice, K4 twice) against the same
    model on the CPU (plain versions): identical tokens, the same wav from them."""
    cfg = HiFiCodecConfig(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
                          upsample_initial_channel=256, encoder_base_channels=16)
    on_gpu, on_cpu = VQVAE(cfg, device=cuda), VQVAE(cfg, device="cpu")
    wav = torch.from_numpy((np.random.default_rng(5).standard_normal((2, 3200)) * 0.1).astype(np.float32))
    with torch.no_grad():
        s = on_cpu.encoder(wav[:, None, :]).std().item()
    cb = torch.from_numpy(np.random.default_rng(6).standard_normal(tuple(on_cpu.quantizer.codebooks.shape)) * s)
    with torch.no_grad():  # the codebooks are a parameter (trained by gradient)
        for m in (on_gpu, on_cpu):
            m.quantizer.codebooks.copy_(cb.float())
    k3, k4 = rb_ops.TOWER_LAUNCHES, rb_ops.GN_TOWER_LAUNCHES
    codes = on_gpu.encode(wav)
    out = on_gpu.decode(codes)
    torch.cuda.synchronize()
    assert (rb_ops.TOWER_LAUNCHES - k3, rb_ops.GN_TOWER_LAUNCHES - k4) == (2, 2)
    codes_cpu = on_cpu.encode(wav)
    torch.testing.assert_close(codes.cpu(), codes_cpu, rtol=0, atol=0)
    torch.testing.assert_close(out.cpu(), on_cpu.decode(codes_cpu), atol=1e-4, rtol=1e-3)


def test_streaming_sessions_cuda_match_cpu(cuda):
    """A tiny causal f32 Encodec streamed on the card (K1 once and K2 once per
    encoder chunk, K2 once per decoder chunk) against the same sessions on the
    CPU (plain versions): identical tokens, the same wav."""
    from academicodec_tpu_torch.streaming import StreamingDecoder, StreamingEncoder

    kw = dict(n_filters=4, dimension=32, ratios=(6, 5, 4, 2), target_bandwidths=(1, 2, 4, 8, 12),
              causal=True, pad_mode="zero")
    on_gpu, on_cpu = SoundStream(device=cuda, **kw), SoundStream(device="cpu", **kw)
    wav = torch.from_numpy((np.random.default_rng(7).standard_normal((2, 4800)) * 0.1).astype(np.float32))
    chunks = wav.split(960, dim=-1)
    k1, k2 = rvq_ops.LAUNCHES, lstm_ops.LAUNCHES
    enc, dec = StreamingEncoder(on_gpu), StreamingDecoder(on_gpu)
    codes = [enc.process(c) for c in chunks]
    out = torch.cat([dec.process(c) for c in codes], -1)
    torch.cuda.synchronize()
    assert (rvq_ops.LAUNCHES - k1, lstm_ops.LAUNCHES - k2) == (len(chunks), 2 * len(chunks))
    enc_cpu, dec_cpu = StreamingEncoder(on_cpu), StreamingDecoder(on_cpu)
    codes_cpu = [enc_cpu.process(c) for c in chunks]
    torch.testing.assert_close(torch.cat(codes, -1).cpu(), torch.cat(codes_cpu, -1), rtol=0, atol=0)
    out_cpu = torch.cat([dec_cpu.process(c) for c in codes_cpu], -1)
    torch.testing.assert_close(out.cpu(), out_cpu, atol=1e-4, rtol=1e-3)


def test_causal_vqvae_streaming_cuda_matches_cpu(cuda):
    """A tiny causal HiFi-Codec generator streamed on the card against the CPU;
    causal stages take no fused tower (K3 is not launched)."""
    from academicodec_tpu_torch.streaming import StreamingVQVAEDecoder

    cfg = HiFiCodecConfig(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
                          upsample_initial_channel=256, encoder_base_channels=16, causal=True)
    on_gpu, on_cpu = VQVAE(cfg, device=cuda), VQVAE(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 1024, size=(2, 25, 4)).astype(np.int32))
    k3 = rb_ops.TOWER_LAUNCHES
    dec = StreamingVQVAEDecoder(on_gpu)
    out = torch.cat([dec.process(c) for c in toks.split(10, dim=1)], -1)
    torch.cuda.synchronize()
    assert rb_ops.TOWER_LAUNCHES == k3
    torch.testing.assert_close(out.cpu(), on_cpu.decode(toks), atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------- K3's convT prologue, K4's lengths


def _k3_pre_case(cuda, dtype, B, C_in, C, T_in, u, kT, post, seed=0):
    """One K3 call with the convT prologue against its plain version; returns
    the kernel's output."""
    resblock, ks, dss = RB1
    rng = np.random.default_rng(seed + C_in + T_in)
    weights, biases = _tower(rng, C, ks, dss, resblock, cuda, dtype)
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock=resblock,
              pre_weight=_randn(rng, (C_in, C, kT), cuda, 1.0 / np.sqrt(C_in * kT / u)).to(dtype),
              pre_bias=_randn(rng, (C,), cuda, 0.1).to(dtype), pre_stride=u, pre_pad=(kT - u) // 2)
    if post:
        kw.update(post_weight=_randn(rng, (1, C, 7), cuda, 0.5 / np.sqrt(C * 7)).to(dtype),
                  post_bias=_randn(rng, (1,), cuda, 0.1).to(dtype), post_tanh=True)
    x = _randn(rng, (B, C_in, T_in), cuda, 0.5).to(dtype)
    before = rb_ops.TOWER_LAUNCHES
    y = rb_ops.resblock_tower(x, weights, biases, **kw)
    torch.cuda.synchronize()
    assert rb_ops.TOWER_LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == (B, 1 if post else C, T_in * u)
    ref = rb_ops.resblock_tower_plain(x, weights, biases, **kw).float()
    torch.testing.assert_close(y.float(), ref, atol=_tol(dtype, ref, 1e-4), rtol=0)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,C_in,C,T_in,u,kT,post",
    [
        (2, 128, 64, 300, 4, 8, False),  # generator stage 2's widths: several tiles
        (2, 128, 64, 296, 4, 8, False),  # T_in % 8 == 0: 16-byte loads of the input window
        (1, 64, 32, 777, 2, 4, True),    # stage 3's, with conv_post + tanh
        (1, 64, 32, 512, 2, 4, True),    # likewise with 16-byte loads
        (2, 32, 16, 45, 2, 4, True),     # C 16
        (2, 64, 32, 3, 2, 4, True),      # T = 6, below the halo
        (1, 40, 16, 100, 8, 16, False),  # C_in not a multiple of C: the FMA path in bf16 too
        (1, 96, 48, 200, 5, 11, False),  # stride 5 (k 11), C 48: the FMA path
        (1, 64, 32, 300, 1, 3, False),   # stride 1
    ],
)
def test_resblock_tower_pre_kernel_matches_plain(cuda, dtype, B, C_in, C, T_in, u, kT, post):
    """K3 with its prologue (lrelu -> phase-major ConvTranspose1d) in
    tower_kernel<C> and tower_fma_kernel, at K3's limits."""
    _k3_pre_case(cuda, dtype, B, C_in, C, T_in, u, kT, post)


@pytest.mark.parametrize("tag,C_in,C,T_in,u,kT,post", [("s2", 128, 64, 30000, 4, 8, False),
                                                        ("s3", 64, 32, 120000, 2, 4, True)])
def test_resblock_tower_pre_flagship_shapes(cuda, tag, C_in, C, T_in, u, kT, post):
    """hificodec_24k_320d's two fused generator stages with their upsampling
    fused in, batch 8 x 10 s, bf16: twice the same bits."""
    y0 = _k3_pre_case(cuda, torch.bfloat16, 8, C_in, C, T_in, u, kT, post, seed=1)
    y1 = _k3_pre_case(cuda, torch.bfloat16, 8, C_in, C, T_in, u, kT, post, seed=1)
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "ks,dss,C,T,lengths",
    [
        ((11, 7, 3), ((1, 3, 5),) * 3, 64, 1100, (1100, 517, 1)),
        ((11, 7, 3), ((1, 3, 5),) * 3, 32, 575, (300, 575)),
        ((3, 7), ((1, 3), (1, 3)), 16, 401, (400, 9, 401)),
        ((11, 7, 3), ((1, 3, 5),) * 3, 128, 333, (333, 100)),  # bf16: the FMA path
    ],
)
def test_resblock_tower_gn_lengths_kernel(cuda, dtype, ks, dss, C, T, lengths):
    """K4 with lengths: against its plain version at K4's limits, pad frames
    exactly 0 (with a nonzero input there), and each row's valid frames the
    bits of a call on that row alone at its exact length."""
    rng = np.random.default_rng(T + C)
    G = len(ks)
    weights, biases = _tower(rng, C, ks, dss, "1", cuda, dtype)
    scs = (_randn(rng, (G, C), cuda, 0.3) + 1.0).to(dtype)
    gbs = _randn(rng, (G, C), cuda, 0.1).to(dtype)
    x = _randn(rng, (len(lengths), C, T), cuda, 0.5).to(dtype)
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock="1", num_groups=C // 16)
    L = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = rb_ops.GN_TOWER_LAUNCHES
    y = rb_ops.resblock_tower_gn(x, weights, biases, scs, gbs, lengths=L, **kw)
    torch.cuda.synchronize()
    assert rb_ops.GN_TOWER_LAUNCHES == before + 1
    ref = rb_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, lengths=L, **kw).float()
    torch.testing.assert_close(y.float(), ref, atol=5e-2 if dtype == torch.bfloat16 else 1e-4, rtol=0)
    for b, n in enumerate(lengths):
        assert torch.count_nonzero(y[b, :, n:]) == 0
        alone = rb_ops.resblock_tower_gn(x[b:b + 1, :, :n].contiguous(), weights, biases, scs, gbs, **kw)
        assert torch.equal(y[b:b + 1, :, :n], alone)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_pass2_kernels_with_lengths_match_plain(cuda, dtype):
    """``gn_affine_kernel`` and ``gn_apply_kernel`` with per-row counts against
    their plain versions."""
    rng = np.random.default_rng(4)
    G, B, C, T = 3, 3, 64, 1000
    L = torch.tensor([1000, 400, 7], dtype=torch.int32, device=cuda)
    rs = _randn(rng, (G, B, C, T), cuda, 0.7).to(dtype) * rb_ops.frame_mask(L, T).to(dtype)
    mom = rb_ops.moments(list(rs))
    scs, gbs = _randn(rng, (G, C), cuda, 0.3) + 1.0, _randn(rng, (G, C), cuda, 0.1)
    A, K = rb_ops.gn_affines_cuda(mom, scs, gbs, 4, 1e-6, T, L)
    A_ref, K_ref = rb_ops.gn_affines(mom, scs, gbs, 4, 1e-6, L)
    torch.testing.assert_close(A, A_ref, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(K, K_ref, rtol=1e-5, atol=1e-6)
    y = rb_ops.gn_apply_cuda(rs, A_ref, K_ref, L)
    assert torch.equal(y, rb_ops.gn_apply(list(rs), A_ref, K_ref, L))


def test_vqvae_masked_encode_and_fused_pre_on_the_card(cuda):
    """The tiny VQVAE on the card, f32: the masked encode of a padded batch
    equals each file's exact-length encode, and the generator with its
    upsampling fused into K3 agrees with the unfused one."""
    from academicodec_tpu_torch.models.hificodec import VQVAE
    from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig

    cfg = HiFiCodecConfig(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
                          upsample_initial_channel=256, encoder_base_channels=16)
    model = VQVAE(cfg, device=cuda)
    rng = np.random.default_rng(13)
    lengths = [1777, 2400, 3999]
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]
    batch = torch.from_numpy(np.stack([np.pad(w, (0, 3999 - len(w))) for w in wavs]))
    codes = model.encode(batch, lengths=lengths)
    for i, w in enumerate(wavs):
        alone = model.encode(torch.from_numpy(w[None]))
        assert alone.shape[1] == model.frames_for(len(w))
        assert torch.equal(codes[i:i + 1, :alone.shape[1]], alone)
    before = rb_ops.TOWER_LAUNCHES
    out = model.decode(codes)
    model.generator.fused_pre = True
    out_pre = model.decode(codes)
    torch.cuda.synchronize()
    assert rb_ops.TOWER_LAUNCHES == before + 4
    torch.testing.assert_close(out_pre, out, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize(
    "B,C,O,K,T,stride,dilation,padding",
    [
        (2, 128, 128, 11, 300, 1, 5, (25, 25)),  # hificodec's widest dilation at 128 channels
        (1, 12, 20, 3, 9, 1, 1, (1, 1)),  # 9 rows: the GEMM's M is padded past 16; K*C=36, O=20 padded to 8s
        (3, 40, 24, 5, 50, 3, 2, (2, 1)),
    ],
)
def test_int8_conv_gemm_matches_plain(cuda, B, C, O, K, T, stride, dilation, padding):
    """cuBLASLt's int8 GEMM on the im2col (``torch._int_mm``) against the f64
    plain version: equal int32 sums, and one GEMM a call."""
    from academicodec_tpu_torch.ops import int8

    g = torch.Generator().manual_seed(B * C + K)
    xi = torch.randint(-127, 128, (B, C, T), generator=g, dtype=torch.int8)
    wi = torch.randint(-127, 128, (O, C, K), generator=g, dtype=torch.int8)
    before = int8.INT_MM_CALLS
    y = int8.conv1d_int32(xi.to(cuda), wi.to(cuda), stride, dilation, padding)
    torch.cuda.synchronize()
    assert int8.INT_MM_CALLS == before + 1 and y.dtype == torch.int32
    assert torch.equal(y.cpu(), int8.conv1d_int32_plain(xi, wi, stride, dilation, padding))


def _lm_pair(cuda, **kw):
    from academicodec_tpu_torch.models.lm import RVQTokenLM

    kw = {**dict(n_q=4, bins=64, dim=32, num_heads=4, num_layers=2, past_context=16), **kw}
    cpu = RVQTokenLM(**kw, device="cpu", seed=3)
    gpu = RVQTokenLM(**kw, device=cuda, seed=3)
    return cpu, gpu


def test_lm_step_on_the_card_matches_the_cpu(cuda):
    """The LM coding step, f32, card against CPU over 20 frames past the
    context: probabilities within atol 1e-5."""
    from academicodec_tpu_torch.codec.lm_compress import make_step

    cpu, gpu = _lm_pair(cuda)
    codes = np.random.default_rng(3).integers(0, 64, (4, 20))
    steps = [make_step(cpu), make_step(gpu)]
    carried = [(None, None), (None, None)]
    prev = [torch.full((1, 1, 4), 64), torch.full((1, 1, 4), 64, device=cuda)]
    for t in range(20):
        pdfs = []
        for i, step in enumerate(steps):
            pdf, *carried[i] = step(prev[i], *carried[i])
            pdfs.append(pdf)
            prev[i] = torch.from_numpy(codes[:, t].reshape(1, 1, 4)).to(prev[i].device)
        np.testing.assert_allclose(pdfs[1], pdfs[0], atol=1e-5, rtol=0, err_msg=f"frame {t}")


def test_lm_blob_coded_on_the_card_decodes_on_the_card(cuda):
    from academicodec_tpu_torch.codec.lm_compress import compress_tokens_with_lm, decompress_tokens_with_lm

    _, gpu = _lm_pair(cuda)
    codes = np.random.default_rng(4).integers(0, 64, (4, 40)).astype(np.int32)
    blob = compress_tokens_with_lm(gpu, codes, metadata={"sr": 24000})
    torch.backends.cuda.matmul.allow_tf32 = True  # the step pins its own precision
    try:
        out, meta = decompress_tokens_with_lm(gpu, blob)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_array_equal(out, codes)
    assert meta["lm"] is True


@pytest.mark.parametrize("layers", [1, 3])
def test_slstm_library_lstm_on_the_card_matches_the_cpu(cuda, layers):
    """N-layer SLSTMs: cuDNN's LSTM on the card against the plain step loop
    on the CPU, f32, from a carry: output and final carry within atol 1e-5."""
    from academicodec_tpu_torch.nn.lstm import SLSTM

    mod = SLSTM(64, num_layers=layers)
    mod.lstm.reset_parameters(torch.Generator().manual_seed(layers))
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 64, 50), generator=g) * 0.5
    carry = tuple((torch.randn((2, 64), generator=g), torch.randn((2, 64), generator=g)) for _ in range(layers))
    with torch.no_grad():
        y_cpu, c_cpu = mod(x, carry, return_carry=True)
        gpu = mod.to(cuda)
        y, c = gpu(x.to(cuda), tuple(tuple(t.to(cuda) for t in hc) for hc in carry), return_carry=True)
    before = lstm_ops.LAUNCHES
    torch.testing.assert_close(y.cpu(), y_cpu, atol=1e-5, rtol=0)
    for hc, hc_cpu in zip(c, c_cpu):
        for a, b in zip(hc, hc_cpu):
            torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
    assert lstm_ops.LAUNCHES == before  # no K2: it is 2-layer only


@pytest.mark.parametrize("norm", ["layer_norm", "time_group_norm"])
def test_post_conv_norms_on_the_card_match_the_cpu(cuda, norm):
    from academicodec_tpu_torch.nn.conv import SConv1d

    conv = SConv1d(16, 24, 7, norm=norm)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        conv.conv.conv.reset_parameters(g)
        conv.conv.norm.weight.normal_(1.0, 0.2, generator=g)
        conv.conv.norm.bias.normal_(0.0, 0.2, generator=g)
        x = torch.randn((2, 16, 300), generator=g)
        ref = conv(x)
        y = conv.to(cuda)(x.to(cuda))
    torch.testing.assert_close(y.cpu(), ref, atol=1e-5, rtol=1e-5)


def test_rvq_kernel_as_kmeans_assignment(cuda):
    """K1 with one layer as the trainer's k-means assignment: N 1600 latent
    frames against 1024 means drawn from them, tokens equal the plain version's."""
    rng = np.random.default_rng(16)
    x = _randn(rng, (1600, 512), cuda)
    means = x[torch.from_numpy(rng.permutation(1600)[:1024]).to(cuda)][None]
    before = rvq_ops.LAUNCHES
    codes = rvq_ops.rvq_encode(x, means)
    torch.cuda.synchronize()
    assert rvq_ops.LAUNCHES == before + 1
    torch.testing.assert_close(codes, rvq_ops.rvq_encode_plain(x, means), rtol=0, atol=0)


def test_training_forward_on_the_card_matches_the_cpu(cuda):
    """``ResidualVQ``'s training forward from an un-inited state, three calls
    (k-means of 3 layers, of the other 3 with the first live, then one search):
    codes equal, quantized, losses and EMA state within 1e-5 (atol and rtol),
    with the K1 launches the code predicts."""
    from academicodec_tpu_torch.quant.core_vq import KMEANS_ITERS, ResidualVQ, sample_rows

    n_q, dim, bins = 6, 64, 128
    cpu = ResidualVQ(n_q, dim, bins)
    cpu.init_training_state()
    gpu = ResidualVQ(n_q, dim, bins).to(cuda)
    gpu.init_training_state()
    rng = np.random.default_rng(2)
    g = torch.Generator().manual_seed(3)
    for call, active in enumerate((3, 6, 6)):
        x = torch.from_numpy(rng.standard_normal((4, 100, dim)).astype(np.float32))
        rows = torch.stack([sample_rows(g, 400, bins) for _ in range(n_q)])
        before = rvq_ops.LAUNCHES
        q, codes, losses = gpu(x.to(cuda), n_q=active, training=True, draws=rows)
        torch.cuda.synchronize()
        launches = rvq_ops.LAUNCHES - before
        q_ref, codes_ref, losses_ref = cpu(x, n_q=active, training=True, draws=rows)
        expected = {0: 3 * (KMEANS_ITERS + 1) + 3, 1: 3 * (KMEANS_ITERS + 1) + 6, 2: 1}[call]
        assert launches == expected, (call, launches)
        torch.testing.assert_close(codes.cpu(), codes_ref, rtol=0, atol=0)
        assert len(torch.unique(codes_ref)) > 8
        torch.testing.assert_close(q.cpu(), q_ref, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(losses.cpu(), losses_ref, atol=1e-5, rtol=1e-5)
        for name in ("embed", "embed_avg", "cluster_size"):
            torch.testing.assert_close(getattr(gpu, name).cpu(), getattr(cpu, name), atol=1e-5, rtol=1e-5)
        assert torch.equal(gpu.inited.cpu(), cpu.inited)


def _slstm(cuda):
    from academicodec_tpu_torch.nn.lstm import SLSTM

    mod = SLSTM(64)
    mod.lstm.reset_parameters(torch.Generator().manual_seed(4))
    x = torch.randn((2, 64, 40), generator=torch.Generator().manual_seed(5)) * 0.5
    return mod, x


def test_slstm_under_autograd_runs_the_library_lstm(cuda):
    """The 2-layer SLSTM with a gradient to take: cuDNN's LSTM, no K2 launch;
    output and input gradient against the plain loop on the CPU (atol 1e-5)."""
    mod, x = _slstm(cuda)
    xc = x.clone().requires_grad_(True)
    mod(xc).square().sum().backward()
    gpu = mod.to(cuda)
    xg = x.to(cuda).requires_grad_(True)
    before = lstm_ops.LAUNCHES
    y = gpu(xg)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert lstm_ops.LAUNCHES == before
    torch.testing.assert_close(xg.grad.cpu(), xc.grad, atol=1e-5, rtol=1e-5)
    assert gpu.lstm.weight_hh_l0.grad is not None and torch.isfinite(gpu.lstm.weight_hh_l0.grad).all()


def test_slstm_without_grad_launches_k2(cuda):
    """The same SLSTM under ``no_grad``: one K2 launch, the output within atol 1e-4
    of the autograd path's on the card (cuDNN against the kernel, f32)."""
    mod, x = _slstm(cuda)
    gpu = mod.to(cuda)
    xg = x.to(cuda)
    ref = gpu(xg).detach()  # parameters require grad: the library LSTM
    before = lstm_ops.LAUNCHES
    with torch.no_grad():
        y = gpu(xg)
    torch.cuda.synchronize()
    assert lstm_ops.LAUNCHES == before + 1
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)


def test_masked_groupnorm_of_a_padded_row_equals_its_exact_length(cuda):
    """``GroupNormTorch`` on the card, f32: a row zero-padded to a bucket, with
    its mask and count, normalizes its valid frames bitwise as the same row at
    its exact length (the wide HiFi-Codec encoder stages of a batched encode;
    ROADMAP.md Queue 3 item 3)."""
    dtype = torch.float32
    from academicodec_tpu_torch.nn.hifigan import GroupNormTorch, frame_mask

    gn = GroupNormTorch(8, 128, epsilon=1e-6)
    with torch.no_grad():
        gn.weight.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(0))
        gn.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    gn = gn.to(cuda)
    rng = np.random.default_rng(9)
    lengths = [29_997, 17_311, 30_000]
    width = 32_768
    rows = [(_randn(rng, (128, n), cuda) + 0.3).to(dtype) for n in lengths]
    batch = torch.zeros((len(rows), 128, width), device=cuda, dtype=dtype)
    for i, r in enumerate(rows):
        batch[i, :, : r.shape[1]] = r
    count = torch.tensor(lengths, device=cuda)
    with torch.no_grad():
        padded = gn(batch, frame_mask(count, width).to(dtype), count)
        for i, r in enumerate(rows):
            exact = gn(r[None])
            assert torch.equal(padded[i, :, : r.shape[1]], exact[0]), i


# ---------------------------------------------------------------- HiFi-Codec trainer
TRAIN_HIFI = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=64,
                  resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), encoder_base_channels=8, n_codes=64)
TRAIN_HIFI_DISCS = dict(stft_filters=4, stft_n_ffts=(256, 128), mpd_periods=(2, 3), msd_scales=2)


@pytest.mark.parametrize("gn", [False, True])
def test_tower_wrappers_raise_under_autograd(cuda, gn):
    """K3/K4 have no backward: a CUDA call that autograd would record raises
    instead of returning a tensor the gradient cannot pass; under ``no_grad``
    the same call launches."""
    rng = np.random.default_rng(3)
    weights, biases = _tower(rng, 32, (3,), ((1, 2),), "1", cuda, torch.float32)
    weights = [[w.requires_grad_(True) for w in ch] for ch in weights]
    x = _randn(rng, (2, 32, 300), cuda, 0.5)
    kw = dict(kernel_sizes=(3,), dilation_sizes=((1, 2),))
    gn_params = (torch.ones((1, 32), device=cuda), torch.zeros((1, 32), device=cuda))

    def call():
        if gn:
            return rb_ops.resblock_tower_gn(x, weights, biases, *gn_params, num_groups=2, **kw)
        return rb_ops.resblock_tower(x, weights, biases, **kw)

    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        y = call()
    assert y.shape == x.shape and torch.isfinite(y).all()


def _hifi_trainer(device, **kw):
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig, HiFiCodecTrainer

    cfg = HiFiCodecTrainConfig(model=HiFiCodecConfig(**TRAIN_HIFI), **TRAIN_HIFI_DISCS, **kw)
    return HiFiCodecTrainer(cfg, device=device)


def _hifi_batch():
    return torch.from_numpy((np.random.default_rng(11).standard_normal((4, 1600)) * 0.3).astype(np.float32))


def test_hifi_d_phase_forward_on_the_towers_equals_the_plain_chains(cuda):
    """The trainer's no-grad generator forward (K4 x2, K3 x2 here) against the
    same model's forward under autograd (every stage unfused), before and after
    a step (the step drops the packed operands its fused Adam leaves stale):
    wavs within 1e-4 of their max, codes equal."""
    trainer = _hifi_trainer(cuda)
    state = trainer.init_state(0)
    x = _hifi_batch().to(cuda)
    for _ in range(2):
        model = state.generator
        k3, k4 = rb_ops.TOWER_LAUNCHES, rb_ops.GN_TOWER_LAUNCHES
        with torch.no_grad():
            y, _, codes = model(x, training=True)
        torch.cuda.synchronize()
        assert (rb_ops.TOWER_LAUNCHES - k3, rb_ops.GN_TOWER_LAUNCHES - k4) == (2, 2)
        y_ref, _, codes_ref = model(x, training=True)
        assert rb_ops.TOWER_LAUNCHES - k3 == 2  # none under autograd
        assert torch.equal(codes, codes_ref)
        torch.testing.assert_close(y, y_ref.detach(), atol=1e-4 * y_ref.abs().max().item(), rtol=0)
        state, _m = trainer.train_step(state, x)


def test_hifi_step_launches_the_towers_only_in_the_d_phase(cuda):
    """K3/K4 launches of one step: one per fused stage in the D phase's forward,
    none in the G phase's; the same in ``eval_step``."""
    import chip_smoke

    trainer = _hifi_trainer(cuda)
    state = trainer.init_state(1)
    x = _hifi_batch().to(cuda)
    by_phase, _wavs, _ = chip_smoke._watch_gen(trainer, lambda: trainer.train_step(state, x))
    expected = chip_smoke.fused_stage_counts(trainer.cfg.model)
    assert by_phase["no_grad"] == expected == {"resblock_tower": 2, "resblock_tower_gn": 2}
    assert not any(by_phase["grad"].values())
    k3, k4 = rb_ops.TOWER_LAUNCHES, rb_ops.GN_TOWER_LAUNCHES
    trainer.eval_step(state, x)
    assert (rb_ops.TOWER_LAUNCHES - k3, rb_ops.GN_TOWER_LAUNCHES - k4) == (2, 2)


def test_spectral_u_advances_once_per_step_on_the_card(cuda):
    """After one step on the card the spectral norm's ``u`` is one power
    iteration from the old ``u`` with the old weight (computed on the CPU),
    as on the CPU, within 1e-5."""
    from academicodec_tpu_torch.nn.conv import _unit

    card, cpu = _hifi_trainer(cuda), _hifi_trainer("cpu")
    card_state, cpu_state = card.init_state(2), cpu.init_state(2)
    convs = [m for m in cpu_state.discriminators.modules() if getattr(m, "norm", None) == "spectral_norm"]
    expected = []
    for m in convs:
        w = m.weight.detach().reshape(m.weight.shape[0], -1)
        expected.append(_unit(w @ _unit(w.t() @ _unit(m.weight_u))))
    x = _hifi_batch()
    card.train_step(card_state, x.to(cuda))
    cpu.train_step(cpu_state, x)
    got = card_state.discriminators.spectral_u()
    assert len(got) == len(expected) == 8
    for g, c, e in zip(got, cpu_state.discriminators.spectral_u(), expected):
        torch.testing.assert_close(g.cpu(), e, atol=1e-5, rtol=0)
        torch.testing.assert_close(g.cpu(), c, atol=1e-5, rtol=0)


def test_mel_distance_on_the_card_matches_the_cpu(cuda):
    """``eval.metrics.mel_distance``'s six scales on the card against the CPU,
    within 1e-4 relative (``chip_smoke.MEL_CARD_CPU_RTOL``)."""
    import chip_smoke
    from academicodec_tpu_torch.eval import metrics

    ref = chip_smoke.speech_like(48000, 24000, seed=1)
    deg = ref + 0.05 * np.random.default_rng(2).standard_normal(ref.shape).astype(np.float32)
    card = metrics.mel_distance(deg, ref, 24000, device=cuda)
    cpu = metrics.mel_distance(deg, ref, 24000, device="cpu")
    assert abs(card - cpu) <= chip_smoke.MEL_CARD_CPU_RTOL * abs(cpu), (card, cpu)
    assert metrics.mel_distance(ref, ref, 24000) == 0.0  # the default device is the card


@pytest.mark.parametrize("family", ["encodec", "hificodec"])
def test_native_loader_trainer_steps_on_the_card(cuda, family, tmp_path):
    """One tiny epoch of each trainer CLI on the card fed by ``--native_loader``
    and by the Python pipeline: the same batches, the first step's losses within
    1e-5 relative, the same launches step for step, and each steady step's
    launches (Encodec, once its layers are inited: K1 x2, K2 x2; HiFi-Codec:
    K3/K4 once per fused stage)."""
    import json

    import chip_smoke
    from academicodec_tpu_torch.cli import train_encodec, train_hificodec
    from academicodec_tpu_torch.data.wavio import write_wav
    from academicodec_tpu_torch.train.encodec import EncodecTrainer
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainer

    rng = np.random.default_rng(4)
    data = tmp_path / "wavs"
    data.mkdir()
    for i in range(8):
        write_wav(str(data / f"w{i}.wav"), (rng.standard_normal(5000) * 0.1).astype(np.float32), 16000)
    if family == "encodec":
        trainer_cls = EncodecTrainer

        def run(native):
            train_encodec.main(["--train_data_path", str(data), "--valid_data_path", str(data), "--path",
                                str(tmp_path / f"ckpt_{native}"), "--sr", "16000", "--ratios", "8", "5", "4", "2",
                                "--target_bandwidths", "1", "2", "4", "--n_filters", "4", "--dimension", "32",
                                "--bins", "64", "--batch_size", "4", "--segment_seconds", "0.2", "--n_epochs", "0",
                                "--discriminator_iter_start", "1", "--debug_tiny_discs"]
                               + (["--native_loader"] if native else []))

        steady = {"rvq_encode": 2, "lstm2": 2, "resblock_tower": 0, "resblock_tower_gn": 0}
    else:
        trainer_cls = HiFiCodecTrainer
        config = tmp_path / "config.json"
        config.write_text(json.dumps(dict(TRAIN_HIFI, sampling_rate=16000, segment_size=2400, seed=5)))
        steady = {"rvq_encode": 0, "lstm2": 0, **chip_smoke.fused_stage_counts(HiFiCodecConfig(**TRAIN_HIFI))}

        def run(native):
            train_hificodec.main(["--config", str(config), "--input_training_file", str(data),
                                  "--input_validation_file", str(data), "--checkpoint_path",
                                  str(tmp_path / f"ckpt_{native}"), "--batch_size", "4", "--training_epochs", "1"]
                                 + (["--native_loader"] if native else []))
    out = chip_smoke._native_pair(family, trainer_cls, run, steady)
    assert out["steps"] == 2 and out["batches_equal"] and out["first_step_loss_rel"] <= chip_smoke.NATIVE_LOSS_RTOL
    assert out["steady_steps"] == ([1] if family == "encodec" else [0, 1])


@pytest.mark.parametrize("family", ["encodec", "hifi"])
def test_data_parallel_step_in_an_nccl_group_of_one(cuda, family):
    """The trainers' data-parallel code in an NCCL group of this process alone,
    at a tiny width, against the plain code from one state with the same draws
    (chip_smoke phase ``parallel`` (a)): JAX's contract, no farther from the
    plain run than a repeat of it, equal K1-K4 launches a step."""
    import chip_smoke
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig  # noqa: F401 (the cases build it)

    cases = chip_smoke.parallel_cases_world1(
        cuda, encodec=dict(sr=16000, ratios=(8, 5, 4, 2), target_bandwidths=(1, 2), n_filters=4, dimension=32,
                           bins=16, mel_scale_powers=(6, 7), stft_filters=8, stft_n_ffts=(256,), mpd_periods=(2, 3),
                           msd_scales=1),
        enc_batch=4, enc_seconds=0.4, enc_steps=2,
        hifi_model=dict(upsample_initial_channel=128, encoder_base_channels=8), hifi_discs=chip_smoke.HIFI_CROSS_DISCS,
        hifi_batch=2, hifi_samples=6400, hifi_steps=2)
    out = chip_smoke._parallel_world1(cuda, cases={family: cases[family]})[family]
    assert out["failures"] == [], out["failures"]
    assert out["distance_parallel_vs_plain"] <= out["distance_plain_repeat"]
    assert out["launches_parallel"] == out["launches_plain"] and any(out["launches_parallel"][-1].values())
    assert not torch.distributed.is_initialized()


def test_data_parallel_compressor_on_the_card_gives_the_plain_blobs(cuda):
    """``SoundStreamCompressor(devices=[cuda:0])`` against the plain compressor,
    a tiny SoundStream in bf16: blobs byte-identical, K1 and K2 launched as often
    (once each: the encoder's search and SLSTM)."""
    import chip_smoke
    from academicodec_tpu_torch.codec.compress import SoundStreamCompressor

    model = SoundStream(n_filters=8, dimension=64, ratios=(8, 5, 4, 2), sample_rate=16000,
                        target_bandwidths=(1, 2, 4), device=cuda, dtype=torch.bfloat16, seed=1)
    batch = chip_smoke.seeded_wav(4, 16000, "cpu", seed=2)
    chip_smoke.spread_codebooks(model, chip_smoke.latent_frames(model, batch))
    wavs = [row.numpy() for row in batch]
    blobs = []
    for comp in (SoundStreamCompressor(model), SoundStreamCompressor(model, devices=[torch.device("cuda", 0)])):
        before = (rvq_ops.LAUNCHES, lstm_ops.LAUNCHES)
        blobs.append(comp.compress_batch(wavs))
        assert (rvq_ops.LAUNCHES - before[0], lstm_ops.LAUNCHES - before[1]) == (1, 1)
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [None, (4000, 2222)])
def test_gn_tower_partials_and_moments_reduce_match_plain(cuda, dtype, lengths):
    """K4's pass 1 with its per-tile partials kept, at [2, 64, 4000], with and
    without lengths: one launch; the chain outputs against the plain chains
    (2e-2 of max |plain| in bf16, 1e-4 in f32, as chip_smoke's towers); the
    partials against the plain per-tile moments of the kernel's own chain
    outputs; ``moments_reduce`` bitwise its plain version (the same f32 adds in
    tile order)."""
    C, T = 64, 4000
    x, weights, biases, scs, gbs, kw = _k4_inputs(cuda, dtype, RB1_ENC[1], RB1_ENC[2], 2, C, T, seed=7)
    L = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda)
    packed = rb_ops.pack_tower(weights, biases, **kw)
    before = rb_ops.GN_TOWER_LAUNCHES
    outs, part = rb_ops.gn_tower_partials(x, packed, L)
    torch.cuda.synchronize()
    assert rb_ops.GN_TOWER_LAUNCHES == before + 1
    TT = rb_ops.gn_tile(packed)
    assert part.shape == (2, -(-T // TT), C, 9)
    ref = rb_ops.gn_tower_partials_plain(x, packed, L)[0].float()
    rel = (outs.float() - ref).abs().max() / ref.abs().max()
    assert rel <= (2e-2 if dtype == torch.bfloat16 else 1e-4)  # K3/K4 against plain, x max |plain|
    torch.testing.assert_close(part, rb_ops.tile_moments_plain(list(outs), TT), rtol=1e-4, atol=1e-2)
    assert torch.equal(rb_ops.moments_reduce(part), rb_ops.moments_reduce_plain(part))


@pytest.mark.parametrize("dtype,C,T", [(torch.bfloat16, 64, 4000), (torch.float32, 32, 1001),
                                       (torch.bfloat16, 128, 333)])  # bf16 at C 128: the FMA path
def test_gn_tower_partials_reduce_to_the_one_call_moments(cuda, dtype, C, T):
    """Pass 1 with its partials kept gives the chain outputs of a call without
    them, and ``moments_reduce`` of its partials that call's moments, bit for
    bit: a time shard's reduction is K4's own."""
    x, weights, biases, scs, gbs, kw = _k4_inputs(cuda, dtype, RB1_ENC[1], RB1_ENC[2], 2, C, T, seed=T)
    packed = rb_ops.pack_tower(weights, biases, **kw)
    outs0, mom0 = rb_ops.gn_tower_chains(x, packed)
    outs1, part = rb_ops.gn_tower_partials(x, packed)
    assert torch.equal(outs0, outs1) and torch.equal(mom0, rb_ops.moments_reduce(part))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_sharded_serving_on_the_card(cuda, dtype):
    """``TimeShardedSoundStream`` and ``TimeShardedVQVAE`` on four time shards of
    one card against the unsharded models at a small width: every shard launches
    K1 (SoundStream) and K3/K4 (VQVAE), the SLSTMs K2 once each; tokens equal
    in f32 (SoundStream: at most 1e-3 of them apart in bf16), wavs of the same
    tokens within 1e-4 in f32 (cuDNN picks a conv's algorithm by its shape) and
    0.05 of max |wav| in bf16. The VQVAE's bf16 tokens are not held at this
    width: a strided conv over a halo'd block (no padding) and over the whole
    sequence (its own padding) may round one bf16 output apart, and at 8-64
    channels with random weights such an ulp moves several percent of the tokens
    (on the CPU too). At full width chip_smoke's phase_sequence holds the bf16
    VQVAE's parted tokens to at most those of an unsharded control, and its K4
    stage bit for bit against one launch."""
    import chip_smoke
    from academicodec_tpu_torch.parallel.sequence import TimeShardedSoundStream, TimeShardedVQVAE

    shards = [torch.device("cuda", 0)] * 4

    def check(ref_codes, codes, ref_wav, wav):
        if dtype == torch.float32:
            assert torch.equal(codes, ref_codes)
            torch.testing.assert_close(wav.float(), ref_wav.float(), atol=1e-4, rtol=0)
        else:
            assert codes is None or (codes != ref_codes).double().mean().item() <= 1e-3
            assert chip_smoke._rel_err(wav, ref_wav) <= 0.05

    model = SoundStream(n_filters=8, dimension=64, ratios=(8, 5, 4, 2), sample_rate=16000,
                        target_bandwidths=(1, 2, 4), device=cuda, dtype=dtype, seed=3)
    wav = chip_smoke.seeded_wav(2, 16000 * 3 + 77, cuda, seed=4)
    chip_smoke.spread_codebooks(model, chip_smoke.latent_frames(model, wav))
    ref = model.encode(wav)
    ts = TimeShardedSoundStream(model, shards)
    chip_smoke.reset_launches()
    codes = ts.encode(wav)
    torch.cuda.synchronize()
    assert len(codes.parts) == 4 and chip_smoke.read_launches()["rvq_encode"] == 4
    assert chip_smoke.read_launches()["lstm2"] == 1
    check(ref, codes.gather(), model.decode(ref), ts.decode(ref).gather())

    vq = VQVAE(HiFiCodecConfig(upsample_rates=(5, 4, 2, 2), upsample_kernel_sizes=(11, 8, 4, 4),
                               encoder_base_channels=8, upsample_initial_channel=128, n_codes=64),
               device=cuda, dtype=dtype, seed=5)
    chip_smoke.spread_codebooks(vq, chip_smoke.latent_frames(vq, wav))
    ref = vq.encode(wav)
    vts = TimeShardedVQVAE(vq, shards)
    chip_smoke.reset_launches()
    tokens = vts.encode(wav)
    out = vts.decode(ref)
    torch.cuda.synchronize()
    counts = chip_smoke.fused_stage_counts(vq.config)
    assert chip_smoke.read_launches() == {"rvq_encode": 0, "lstm2": 0, **{k: 4 * n for k, n in counts.items()}}
    check(ref, tokens.gather() if dtype == torch.float32 else None, vq.decode(ref), out.gather())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_k4_stage_is_one_launch_bit_for_bit(cuda, dtype):
    """The encoder's K4 stage over four time shards of the card (each owning the
    whole tiles that start in it, the partials reduced in the sequence's tile
    order) gives the bits of one launch over the whole sequence: four launches,
    output equal."""
    from academicodec_tpu_torch.parallel import sequence

    vq = VQVAE(HiFiCodecConfig(upsample_rates=(5, 4, 2, 2), upsample_kernel_sizes=(11, 8, 4, 4),
                               encoder_base_channels=32, upsample_initial_channel=128, n_codes=64),
               device=cuda, dtype=dtype, seed=6)
    enc = vq.encoder
    rng = np.random.default_rng(6)
    wav = _randn(rng, (2, 1, 48000 + 77), cuda, 0.1).to(dtype)
    with torch.no_grad():
        x = enc.ups[0](torch.nn.functional.leaky_relu(enc.conv_pre(wav), 0.1))
        norms = enc.stage(0)[1]
        packed = enc.packed_tower(0)
        ref = rb_ops.resblock_tower_gn(x, packed, None, torch.stack([n.weight for n in norms]),
                                       torch.stack([n.bias for n in norms]), num_groups=x.shape[1] // 16)
        spans = [(a * 40, min(b * 40, x.shape[2])) for a, b in sequence.time_blocks(-(-x.shape[2] // 40), 4)]
        before = rb_ops.GN_TOWER_LAUNCHES
        got = sequence._encoder_stage_gn_fused([enc] * 4, 0, sequence.split_time(x, spans, [cuda] * 4), None)
        torch.cuda.synchronize()
    assert rb_ops.GN_TOWER_LAUNCHES == before + 4
    assert torch.equal(got.gather(), ref)
