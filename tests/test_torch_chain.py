"""The int8 probe's two conv chains (``ops/cuda/chain.py``, P1 and P2) against
the JAX probe's Pallas kernels, on the CPU.

``benchmarks/pallas_int8_probe.py`` has no ``__init__.py``, so it is imported
by path. Its kernel bodies run through ``pl.pallas_call(..., interpret=True)``
(``s_act`` in SMEM, as the probe passes it); the port's wrappers take CPU
tensors and so run their plain versions. Inputs are numpy arrays from seeds,
handed to both sides in the same tap-major layout. Limits: P1 within 1e-2 of
max |JAX| (the two sum in other orders, and a bf16 rounding that parts
travels down the chain); P2 at most one bf16 ulp apart in at most 1e-3 of the
elements (its int32 sums are exact; the dequantizing multiply-add may round
apart in XLA); the calibration bit for bit.
"""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from academicodec_tpu_torch.ops.cuda import chain
from academicodec_tpu_torch.probes import int8_chain
from academicodec_tpu_torch.utils import profiling

_SPEC = importlib.util.spec_from_file_location(
    "pallas_int8_probe", Path(__file__).resolve().parents[1] / "benchmarks" / "pallas_int8_probe.py")
probe = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(probe)

P, K = 6, 7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread keeps parallel pytest workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(C, TT, seed, B=None):
    """The probe's scales: x ~ N(0, 0.5^2) (rounded to bf16 on both sides), W ~
    N(0, 1 / 7C), b ~ N(0, 0.01^2), all f32 numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, TT) if B is None else (B, C, TT)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((P, C, K * C)) / np.sqrt(K * C)).astype(np.float32)
    b = (rng.standard_normal((P, C, 1)) * 0.01).astype(np.float32)
    return x, w, b


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _jax_p1(x, w, b):
    C, TT = x.shape
    f = pl.pallas_call(functools.partial(probe._chain_kernel_bf16, P, K),
                       out_shape=jax.ShapeDtypeStruct((C, TT), jnp.bfloat16), interpret=True)
    return np.asarray(f(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(b)),
                      np.float32)


def _jax_p2(x, wq, ws, b, s_act):
    C, TT = x.shape
    f = pl.pallas_call(
        functools.partial(probe._chain_kernel_i8, P, K),
        out_shape=jax.ShapeDtypeStruct((C, TT), jnp.bfloat16),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4 + [pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )
    return np.asarray(f(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(b),
                        jnp.asarray(s_act)), np.float32)


def _jax_calibration(x, w, b):
    """``run_case``'s arithmetic (benchmarks/pallas_int8_probe.py:84-105): the
    amax of each conv's input in its ``ref_chain``, then numpy scales."""
    def ref_chain(x, w, b):
        cur, scales = x, []
        for p in range(P):
            scales.append(jnp.max(jnp.abs(cur.astype(jnp.float32))))
            col = probe._shift_cols(cur.astype(jnp.float32), K, 1)
            y = w[p] @ col + b[p]
            cur = jnp.where(y >= 0, y, 0.1 * y).astype(x.dtype)
        return cur, jnp.stack(scales)

    ref, amax = jax.jit(ref_chain)(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    s_act = np.maximum(np.asarray(amax), 1e-6) / 127.0
    wq = np.zeros(w.shape, np.int8)
    ws = np.zeros((P, w.shape[1], 1), np.float32)
    for p in range(P):
        sc = np.maximum(np.abs(w[p]).max(axis=1), 1e-12) / 127.0
        wq[p] = np.clip(np.round(w[p] / sc[:, None]), -127, 127).astype(np.int8)
        ws[p] = sc[:, None].astype(np.float32)
    return dict(ref=np.asarray(ref, np.float32), amax=np.asarray(amax), s_act=s_act, wq=wq, ws=ws)


def _bf16_ulps(a, b):
    """Distance in bf16 steps between two arrays of bf16 values (f32 arrays)."""
    def key(v):
        i = torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs().numpy()


@pytest.mark.parametrize("k,d", [(7, 1), (3, 2)])
def test_shift_cols_matches_the_probe(k, d):
    a = np.random.default_rng(k).standard_normal((8, 20)).astype(np.float32)
    np.testing.assert_array_equal(chain.shift_cols(torch.from_numpy(a), k, d).numpy(),
                                  np.asarray(probe._shift_cols(jnp.asarray(a), k, d)))


def test_to_oik_is_torch_layout_of_the_tap_major_weights():
    """``conv1d(x, to_oik(W)[p], padding=3) == W[p] @ shift_cols(x)`` (f64, exact order aside)."""
    x, w, _ = _inputs(16, 40, 1)
    xt, wt = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    for p in range(P):
        got = torch.nn.functional.conv1d(xt[None], chain.to_oik(wt)[p], padding=3)[0]
        torch.testing.assert_close(got, wt[p] @ chain.shift_cols(xt), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("C,TT", [(16, 256), (32, 384), (64, 256), (32, 12), (64, 5)])
def test_p1_plain_matches_the_pallas_kernel(C, TT):
    """Includes tiles shorter than the chain's halo of 18 (every conv reads zeros
    past both ends of the tile)."""
    x, w, b = _inputs(C, TT, C + TT)
    ref = _jax_p1(x, w, b)
    before = profiling.total("p1.launches").count
    got = chain.conv_chain_bf16(_bf16(x), chain.pack_chain_bf16(torch.from_numpy(w), torch.from_numpy(b)))
    assert profiling.total("p1.launches").count == before and got.dtype == torch.bfloat16 and got.shape == (C, TT)
    assert np.abs(got.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("C,TT", [(16, 256), (32, 384), (64, 256), (32, 12), (64, 5)])
def test_p2_plain_matches_the_pallas_kernel(C, TT):
    x, w, b = _inputs(C, TT, 2 * C + TT)
    cal = _jax_calibration(x, w, b)
    ref = _jax_p2(x, cal["wq"], cal["ws"], b, cal["s_act"])
    before = profiling.total("p2.launches").count
    ops = chain.pack_chain_i8(*(torch.from_numpy(cal[k]) for k in ("wq", "ws")), torch.from_numpy(b),
                              torch.from_numpy(cal["s_act"]))
    got = chain.conv_chain_i8(_bf16(x), ops).float().numpy()
    assert profiling.total("p2.launches").count == before
    ulps = _bf16_ulps(got, ref)
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-3
    # W8A8 stays within the port's int8 limit of the f32 reference chain
    assert np.linalg.norm(got - cal["ref"]) / np.linalg.norm(cal["ref"]) <= 0.12


@pytest.mark.parametrize("C,TT", [(32, 512), (64, 256), (16, 9)])
def test_calibration_matches_run_case_bitwise(C, TT):
    x, w, b = _inputs(C, TT, 3 * C + TT)
    ref = _jax_calibration(x, w, b)
    got = chain.calibrate(_bf16(x), torch.from_numpy(w), torch.from_numpy(b))
    for key in ("amax", "s_act", "wq", "ws"):
        assert got[key].numpy().dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    # the reference output itself sums in another order: P1's limit
    assert np.abs(got["ref"].float().numpy() - ref["ref"]).max() <= 1e-2 * np.abs(ref["ref"]).max()
    assert float(chain.act_scales(torch.zeros(1))[0]) == np.float32(1e-6) / np.float32(127.0)


def test_a_batch_is_rows_of_separate_sequences():
    """``[B, C, TT]``: each row its own tile with its own ends, bit for bit the
    row alone, and the row alone against JAX's P2."""
    x, w, b = _inputs(32, 100, 5, B=3)
    cal = chain.calibrate(_bf16(x), torch.from_numpy(w), torch.from_numpy(b))
    ops16 = chain.pack_chain_bf16(torch.from_numpy(w), torch.from_numpy(b))
    ops8 = chain.pack_chain_i8(cal["wq"], cal["ws"], torch.from_numpy(b), cal["s_act"])
    y16 = chain.conv_chain_bf16(_bf16(x), ops16)
    y8 = chain.conv_chain_i8(_bf16(x), ops8)
    for i in range(3):
        assert torch.equal(y16[i], chain.conv_chain_bf16(_bf16(x[i]), ops16))
        assert torch.equal(y8[i], chain.conv_chain_i8(_bf16(x[i]), ops8))
    ref = _jax_p2(x[1], *(c.numpy() for c in (cal["wq"], cal["ws"])), b, cal["s_act"].numpy())
    ulps = _bf16_ulps(y8[1].float().numpy(), ref)
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-3


def test_wrappers_device_rules():
    """A CPU call runs the plain version on the arrays as given and counts no
    launch; mixed devices raise (a meta tensor stands in for a second device),
    as do operands packed for the other chain, f32 weights where int8 are due
    and weights that are not ``[P, C, 7C]``."""
    x, w, b = _inputs(16, 30, 6)
    xt, wt, bt = _bf16(x), torch.from_numpy(w), torch.from_numpy(b)
    cal = chain.calibrate(xt, wt, bt)
    q = (cal["wq"], cal["ws"], bt, cal["s_act"])
    before = profiling.total("p1.launches").count, profiling.total("p2.launches").count
    assert torch.equal(chain.conv_chain_bf16(xt, chain.pack_chain_bf16(wt, bt)),
                       chain.conv_chain_bf16_plain(xt, wt, bt))
    assert torch.equal(chain.conv_chain_i8(xt, chain.pack_chain_i8(*q)), chain.conv_chain_i8_plain(xt, *q))
    assert (profiling.total("p1.launches").count, profiling.total("p2.launches").count) == before
    with pytest.raises(ValueError):
        chain.pack_chain_bf16(wt, bt.to("meta"))
    with pytest.raises(ValueError):
        chain.conv_chain_i8(xt.to("meta"), chain.pack_chain_i8(*q))
    with pytest.raises(ValueError):
        chain.conv_chain_i8(xt, chain.pack_chain_bf16(wt, bt))
    with pytest.raises(ValueError):
        chain.pack_chain_i8(wt, *q[1:])  # f32 weights where int8 are due
    with pytest.raises(ValueError):
        chain.pack_chain_bf16(wt[:, :, :-1], bt)


def _unpack(packed, P, C, dtype):
    """The kernel's A operand ``[P, 64, offsets C]`` from the packed bytes: each
    tile unswizzled (the permutation is an involution), the tiles of a conv side
    by side along K."""
    lay = chain.ChainLayout(C, torch.empty((), dtype=dtype).element_size(), P)
    raw = packed.view(P * lay.tiles_per_conv, lay.tile_bytes)[:, chain.swizzle_perm(lay.line, lay.tile_bytes)]
    per = lay.line // lay.itemsize
    tiles = raw.contiguous().view(dtype).view(P, lay.tiles_per_conv, chain.M_ROWS, per)
    return tiles.permute(0, 2, 1, 3).reshape(P, chain.M_ROWS, lay.tiles_per_conv * per)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("C", [32, 64])
def test_tap_packing(C, dtype):
    """The A tiles unpack to the ``[P, C, 7C]`` weights: row ``r C + co`` of M holds
    output channel ``co`` of phase ``r`` (int8: channel ``out_channel_perm[co]``,
    so rows g and g + 8 of 16 are channels 2g and 2g + 1) at row offsets ``r .. r
    + 6``; the rest of K and M is 0. Each tile is swizzled with the pattern of its
    line width (128 bytes at C 64 bf16 and C 32 bf16's two phases, 64 at C 64
    int8 and C 32 int8's two phases)."""
    w = torch.from_numpy(_inputs(C, 8, C)[1])
    wt = chain.quantize_weights(w)[0] if dtype == torch.int8 else w.to(dtype)
    lay = chain.ChainLayout(C, wt.element_size(), P)
    assert lay.phases == 64 // C and lay.line == 64 * wt.element_size()
    perm = chain.swizzle_perm(lay.line, lay.tile_bytes)
    assert torch.equal(perm[perm], torch.arange(lay.tile_bytes))
    if lay.line == 128:  # the 128-byte pattern: row i of an 8-row atom has its chunks XORed with i
        assert perm.view(-1, 8, 16)[3, 5, 0] == 3 * 128 + (5 ^ 3) * 16
    packed = chain.pack_taps_chain(wt)
    assert packed.dtype == torch.uint8 and packed.numel() == P * lay.tiles_per_conv * lay.tile_bytes
    a = _unpack(packed, P, C, dtype).view(P, chain.M_ROWS, lay.offsets, C)
    rows = chain.out_channel_perm(C) if dtype == torch.int8 else torch.arange(C)
    if dtype == torch.int8:
        assert rows[:16].tolist() == [0, 2, 4, 6, 8, 10, 12, 14, 1, 3, 5, 7, 9, 11, 13, 15]
    taps = wt.view(P, C, K, C)[:, rows]  # [p, row, j, ci]
    expected = torch.zeros_like(a)
    for r in range(lay.phases):
        expected[:, r * C:(r + 1) * C, r:r + K] = taps
    assert torch.equal(a, expected)
    assert torch.equal(chain.unswizzled_taps(wt), expected)


def _model_one_conv(x, w, b, ws=None, s=None, cols=chain.N_COLS):
    """The kernel's index math for one conv (P = 1) over ``x [C, T]`` bf16, on the
    CPU; P2 where ``ws``, ``s`` are given (``w`` int8). Per block, the window
    ``[rows][C]`` holds global positions ``g0 + r`` (0 outside ``[0, T)``; P2
    quantized through the thresholds). Per consumer warpgroup and half (two of
    them a warpgroup at ``cols`` 256, one in the narrow block's 128), B is the
    window's overlapping view ``as_strided((128, offsets C), (phases C, 1))``
    from row ``FIRST_ROW + wg span + half 128 phases - 3``, A the unpacked tiles;
    accumulator row ``m`` is phase ``m // C`` of its (permuted) channel, column
    ``n`` window row ``row0 + phases n + phase``; the block writes rows ``[out0,
    out0 + TT)``."""
    C, T = x.shape
    int8 = ws is not None
    lay = chain.ChainLayout(C, 1 if int8 else 2, 1, cols)
    a = _unpack(chain.pack_taps_chain(w), 1, C, w.dtype)[0].double()
    rows = chain.out_channel_perm(C) if int8 else torch.arange(C)
    tau = chain.quant_thresholds(s)[0] if int8 else None
    n = chain.N_HALF
    y = torch.zeros((C, T), dtype=torch.bfloat16)
    for tile in range(-(-T // lay.tile)):
        g0 = tile * lay.tile - lay.out0
        pos = torch.arange(lay.rows) + g0
        inside = (pos >= 0) & (pos < T)
        win = torch.zeros((lay.rows, C))
        win[inside] = x[:, pos[inside]].t().float()
        if int8:
            win = chain.quantize_act_thresholds(win, s[0], tau)
        flat = win.double().reshape(-1)
        for wg in range(chain.CONSUMERS):
            for half in range(cols // n):
                row0 = chain.FIRST_ROW + wg * lay.span + half * n * lay.phases
                bmat = flat.as_strided((n, lay.offsets * C), (lay.phases * C, 1), (row0 - 3) * C)
                acc = (a @ bmat.t()).float()  # [64, 128], exact
                for m in range(lay.phases * C):
                    r, co = divmod(m, C)
                    ch = int(rows[co])
                    out_rows = row0 + lay.phases * torch.arange(n) + r
                    keep = (out_rows >= lay.out0) & (out_rows < lay.out0 + lay.tile) & (g0 + out_rows < T)
                    v = acc[m] * (s[0] * ws.reshape(-1)[ch]) if int8 else acc[m]
                    v = v + b.reshape(-1)[ch]
                    y[ch, (g0 + out_rows)[keep]] = torch.where(v >= 0, v, 0.1 * v).to(torch.bfloat16)[keep]
    return y


def _check_descriptor_model(C, tiles, int8, cols):
    T = int(chain.ChainLayout(C, 2, 1, cols).tile * tiles)
    x, w, b = _inputs(C, T, C + T)
    xt, wt, bt = _bf16(x), torch.from_numpy(w[:1]), torch.from_numpy(b[:1])
    if int8:
        cal = chain.calibrate(xt, torch.from_numpy(w), torch.from_numpy(b))
        wq, ws, s = cal["wq"][:1], cal["ws"][:1], cal["s_act"][:1]
        assert torch.equal(_model_one_conv(xt, wq, bt, ws, s, cols), chain.conv_chain_i8_plain(xt, wq, ws, bt, s))
    else:
        got = _model_one_conv(xt, wt.to(torch.bfloat16), bt, cols=cols).float()
        ref = chain.conv_chain_bf16_plain(xt, wt, bt).float()
        assert (got != ref).float().mean() <= 1e-3 and (got - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C,tiles", [(32, 1.0), (64, 1.0), (32, 2.3), (64, 2.3)])
def test_descriptor_model_equals_one_conv(C, tiles, int8):
    """The CPU model of the kernel's geometry (:func:`_model_one_conv`) against
    one conv of the plain versions: at one whole tile (the tile's edge is the
    sequence's) and over a ragged last tile. P1's products are exact here (f64
    sums of bf16 products), so it matches up to the plain version's own f32
    sums: equal but for at most 1e-3 of the elements, those within P1's
    limit; P2 bit for bit."""
    _check_descriptor_model(C, tiles, int8, chain.N_COLS)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C", [32, 64])
def test_descriptor_model_of_the_narrow_block(C, int8):
    """The same model for the narrow block of short sequences (one N 128 half a
    warpgroup, half the tile), over a ragged last tile."""
    _check_descriptor_model(C, 2.3, int8, chain.N_HALF)


@pytest.mark.parametrize("C,TT", list(int8_chain.CASES) + [(None, None)])
def test_threshold_quantizer_equals_quantize_act(C, TT):
    """The kernel's quantizer (its plain version :func:`quantize_act_thresholds`)
    equals :func:`quantize_act` for every finite bf16 value and +-inf: at the six
    calibrated scales of each of the probe's four cases, and (``C`` None) at the
    five scales of the card's every-bf16-value test."""
    if C is None:
        scales = torch.tensor([0.0123, 3.7 / 127, 2.0 ** -5, 1e-6 / 127, 0.1 / 3])
    else:
        x, w, b = int8_chain.make_inputs(C, TT)
        scales = chain.calibrate(x, w, b)["s_act"]
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    v = bits[~torch.isnan(bits.float())]
    assert torch.isinf(v.float()).sum() == 2 and v.numel() == 65536 - 254
    tau = chain.quant_thresholds(scales)
    assert tau.shape == (scales.numel(), 256) and torch.isnan(tau[:, -1]).all() and torch.isneginf(tau[:, 0]).all()
    for s, t in zip(scales, tau):
        ref = chain.quantize_act(v, s)
        assert torch.equal(chain.quantize_act_thresholds(v, s, t), ref)
        assert ref.min() == -127 and ref.max() == 127  # both clips reached (+-inf at least)


@pytest.mark.parametrize("s", ["eps", "calibrated", 1.0, 1e3 / 127])
def test_fused_candidate_at_the_scale_extremes(s):
    """The kernel's candidate ``fma(v, 1/s, -2^-13)`` (one rounding, modelled in
    f64) at the smallest scale the calibration gives (``1e-6 / 127``), the
    largest of the probe's four cases, and two larger ones: for every bf16 value
    it lies at or one step below ``rint(v / s)`` before the clip, so one
    threshold decides, and the quantizer equals :func:`quantize_act`."""
    if s == "eps":
        s = chain.act_scales(torch.zeros(1))[0]
    elif s == "calibrated":
        s = torch.stack([chain.calibrate(*int8_chain.make_inputs(C, TT))["s_act"].max()
                         for C, TT in int8_chain.CASES]).max()
    s = torch.as_tensor(s, dtype=torch.float32)
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    v = bits[~torch.isnan(bits.float())].float()
    inv = torch.reciprocal(s)
    fused = (v.double() * inv.double() - chain.QBIAS).float()
    exact = torch.round(v / s)
    finite = torch.isfinite(exact) & (exact.abs() <= 200)
    step = torch.round(fused[finite]) - exact[finite]
    assert ((step == 0) | (step == -1)).all() and (step == -1).any()
    assert torch.equal(chain.quantize_act_thresholds(v, s, chain.quant_thresholds(s[None])[0]),
                       chain.quantize_act(v, s))


def test_tile_geometry():
    """Each block's two consumer warpgroups compute 2 x 256 columns of every conv
    (one phase: 512 rows; two at C 32: 1024), or 2 x 128 in the narrow block;
    its output rows start even past the last conv's halo and fit the rows that
    conv leaves valid. (The kernel's shared memory is its own: a static assert
    in csrc/chain.cu, read back on the card by ``chain.kernel_geometry``.)"""
    for C in (32, 64):
        for itemsize in (1, 2):
            for p in (1, 6, 8):
                for cols in (chain.N_COLS, chain.N_HALF):
                    lay = chain.ChainLayout(C, itemsize, p, cols)
                    assert lay.rows == chain.FIRST_ROW + 2 * cols * lay.phases + 3
                    assert lay.out0 % 2 == 0 and lay.out0 >= 3 * p + 1 and lay.tile % 8 == 0
                    assert lay.out0 + lay.tile <= lay.rows - 3 * p < lay.out0 + lay.tile + 8
                    assert lay.tiles_per_conv * lay.tile_bytes == 64 * lay.offsets * C * itemsize
    assert chain.chain_tile(P, 64) == 480 and chain.chain_tile(P, 32) == 992
    assert chain.chain_tile(P, 64, chain.N_HALF) == 224 and chain.chain_tile(P, 32, chain.N_HALF) == 480
    assert chain.ChainLayout(64, 2, P).blocks(8, 120000) == 8 * 250


@pytest.mark.parametrize("B,C,T", [(8, 64, 120000), (8, 32, 240000), (1, 64, 8192), (1, 32, 8192),
                                   (1, 64, 4096), (1, 32, 4096), (2, 64, 5), (3, 64, 8000), (4, 64, 8000)])
def test_short_sequences_take_the_narrow_block(B, C, T):
    """The narrow block where all of its blocks run at once on the H100's 132
    SMs, the wide one otherwise: the decision shapes stay wide, the probe's
    one-tile cases go narrow (18 and 5-9 wide blocks would leave most SMs idle),
    and between ``[3, 64, 8000]`` and ``[4, 64, 8000]`` the rule turns (108 and 144
    narrow blocks against 132)."""
    cols = chain.chain_cols(B, T, P, C, 132)
    narrow = chain.ChainLayout(C, 2, P, chain.N_HALF).blocks(B, T)
    assert cols == (chain.N_HALF if narrow <= 132 else chain.N_COLS)
    assert (cols == chain.N_HALF) == ((B, T) not in ((8, 120000), (8, 240000), (4, 8000)))


def test_chain_bounds_at_the_decision_shapes():
    """The bounds, the rule, and the launches one run on the card makes of each
    kernel (chip_smoke holds the counts to it)."""
    s2 = int8_chain.chain_bounds(8, 64, 120000)
    assert s2["ops"] == 2 * 6 * 64 * 7 * 64 * 8 * 120000
    assert abs(s2["bound_bf16_ms"] - s2["ops"] / 989e12 * 1e3) < 1e-12 and s2["bound_bf16_by"] == "operations"
    assert abs(s2["bound_i8_ms"] - s2["ops"] / 1979e12 * 1e3) < 1e-12
    assert int8_chain.decide([{"ratio": 1.3}, {"ratio": 1.25}]) == "wire int8 towers"
    assert int8_chain.decide([{"ratio": 1.3}, {"ratio": 1.2}]) == "keep bf16 towers"
    assert int8_chain.launches_per_kernel(len(int8_chain.CASES), len(int8_chain.SHAPES)) == 4 * 33 + 2 * 12


def test_probe_entry_point_rehearsal(capsys):
    """``python -m academicodec_tpu_torch.probes.int8_chain --device cpu --tiny``:
    a device line, the four cases with the probe's keys, the two decision
    shapes, the decision line; nothing timed on the CPU, no launch."""
    before = profiling.total("p1.launches").count, profiling.total("p2.launches").count
    assert int8_chain.main(["--device", "cpu", "--tiny"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows[0] == {"device": "cpu"} and len(rows) == 1 + 4 + 2 + 1
    for r in rows[1:5]:
        assert {"C", "TT", "bf16_ms", "i8_ms", "ratio", "err_bf16", "err_i8", "bound_bf16_ms", "bound_i8_ms"} <= set(r)
        assert r["bf16_ms"] is None and r["p2_bitwise"] and r["err_i8"] < 0.1
    assert [r["shape"] for r in rows[5:7]] == ["s2", "s3"]
    assert rows[-1]["decision"] == "not taken: no device time"
    assert (profiling.total("p1.launches").count, profiling.total("p2.launches").count) == before


def test_chip_smoke_probe_chain_rehearsal():
    """chip_smoke's ``probe_chain`` phase at the probe's ``--tiny`` sizes on the
    CPU: no launch of any kernel, the checks pass, and both kernels' entries
    carry every key of the ``kernels`` line."""
    import chip_smoke

    r = chip_smoke.phase_probe_chain("cpu", tiny=True)
    assert not any(r["launches"].values())
    assert all(row["p2_bitwise"] and row["rel_l2_i8"] <= 0.12 for row in r["cases"] + r["shapes"])
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    assert [k["name"] for k in r["kernels"]] == ["conv_chain_bf16", "conv_chain_i8"]
    assert all(keys <= set(k) and k["route"] == "cuda" and k["bound_ms"] > 0 for k in r["kernels"])
