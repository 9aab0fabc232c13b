"""K3/K4 plain versions against the JAX Pallas resblock towers, on the CPU.

The Pallas kernels run in interpret mode, as tests/test_pallas_resblock.py
runs them; the port's wrappers take CPU tensors and so run their plain
versions (``resblock_tower_plain``, ``resblock_tower_gn_plain``). Inputs come
from numpy seeds; weights go across as ``[k, C_in, C_out]`` -> ``[O, I, K]``.
Tolerances are those of the JAX package's own tests: f32 1e-5 (2e-5 with the
post epilogue), 3e-5 for the GroupNorm bundle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import academicodec_tpu.ops.pallas.resblock as jrb
from academicodec_tpu_torch.ops.cuda import resblock as rb
from academicodec_tpu_torch.utils import profiling

RB1 = ("1", (3, 7, 11), ((1, 3, 5),) * 3)
RB2 = ("2", (3, 7), ((1, 3), (1, 3)))


def _rand_tower(rng, ks, dss, resblock, C, scale=0.1):
    weights, biases = [], []
    for k, ds in zip(ks, dss):
        n = len(rb.chain_conv_dilations(ds, resblock))
        weights.append(tuple((rng.standard_normal((k, C, C)) * scale).astype(np.float32) for _ in range(n)))
        biases.append(tuple((rng.standard_normal(C) * scale).astype(np.float32) for _ in range(n)))
    return weights, biases


def _to_jax(weights, biases):
    return (tuple(tuple(jnp.asarray(w) for w in ch) for ch in weights),
            tuple(tuple(jnp.asarray(b) for b in ch) for ch in biases))


def _to_torch(weights, biases, dtype=torch.float32):
    return ([[torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))).to(dtype) for w in ch]
             for ch in weights],
            [[torch.from_numpy(b).to(dtype) for b in ch] for ch in biases])


def _run_both(x, weights, biases, resblock, ks, dss, dtype=np.float32, post=None):
    """JAX ``resblock_tower`` (interpret) and the port's wrapper on CPU tensors,
    both returned as f32 numpy ``[B, T, C_out]``."""
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jkw, tkw = {}, {}
    if post is not None:
        wp, bp = post
        jkw = dict(post_kernel=jnp.asarray(wp), post_bias=jnp.asarray(bp), post_tanh=True)
        tkw = dict(post_weight=torch.from_numpy(np.ascontiguousarray(wp.transpose(2, 1, 0))).to(tdt),
                   post_bias=torch.from_numpy(bp).to(tdt), post_tanh=True)
    jw, jb = _to_jax(weights, biases)
    ref = jrb.resblock_tower(jnp.asarray(x, jdt), jw, jb, kernel_sizes=ks, dilation_sizes=dss,
                             resblock=resblock, interpret=True, **jkw)
    tw, tb = _to_torch(weights, biases, tdt)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).to(tdt)
    out = rb.resblock_tower(xt, tw, tb, kernel_sizes=ks, dilation_sizes=dss, resblock=resblock, **tkw)
    assert out.dtype == tdt
    return np.asarray(ref, np.float32), out.float().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("resblock,ks,dss", [RB1, RB2])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_tower_plain_matches_pallas(resblock, ks, dss, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 700, 32)) * 0.5).astype(np.float32)
    weights, biases = _rand_tower(rng, ks, dss, resblock, 32)
    before = profiling.total("k3.launches").count
    ref, out = _run_both(x, weights, biases, resblock, ks, dss, dtype=dtype)
    assert profiling.total("k3.launches").count == before  # CPU tensors run the plain version
    assert out.shape == ref.shape
    # bf16: both round at the same points; only f32 summation order differs,
    # which can flip a bf16 rounding (the JAX package's bf16 tower tolerance)
    tol = 1e-5 if dtype == np.float32 else 1.5e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=float(tol))


@pytest.mark.parametrize("T", [1000, 50])
def test_tower_plain_post_epilogue_matches_pallas(T):
    """lrelu -> conv_post (k 7, C -> 1) -> tanh, at a long T and at a T below
    the 60-sample halo, where every output sees the zero edges."""
    rng = np.random.default_rng(3)
    resblock, ks, dss = RB1
    x = (rng.standard_normal((1, T, 32)) * 0.5).astype(np.float32)
    weights, biases = _rand_tower(rng, ks, dss, resblock, 32)
    post = ((rng.standard_normal((7, 32, 1)) * 0.1).astype(np.float32),
            (rng.standard_normal(1) * 0.1).astype(np.float32))
    ref, out = _run_both(x, weights, biases, resblock, ks, dss, post=post)
    assert out.shape == (1, T, 1)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("resblock,ks,dss", [RB1, RB2])
def test_tower_plain_below_halo_matches_pallas(resblock, ks, dss):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 37, 16)) * 0.5).astype(np.float32)
    weights, biases = _rand_tower(rng, ks, dss, resblock, 16)
    ref, out = _run_both(x, weights, biases, resblock, ks, dss)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize(
    "T,ks,dss",
    [
        (575, (3, 7), ((1, 3), (1, 3))),
        (1024, (3, 7), ((1, 3), (1, 3))),
        (300, (11, 7, 3), ((1, 3, 5),) * 3),  # the encoder's chain order
    ],
)
def test_gn_tower_plain_matches_pallas(T, ks, dss):
    """The moments-based bundle, f32, at odd and tile-multiple lengths."""
    rng = np.random.default_rng(11)
    C, G = 32, len(ks)
    weights, biases = _rand_tower(rng, ks, dss, "1", C)
    scs = (rng.standard_normal((G, C)) * 0.3 + 1.0).astype(np.float32)
    gbs = (rng.standard_normal((G, C)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((2, T, C)) * 0.3).astype(np.float32)
    jw, jb = _to_jax(weights, biases)
    ref = np.asarray(jrb.resblock_tower_gn(
        jnp.asarray(x), jw, jb, jnp.asarray(scs), jnp.asarray(gbs), kernel_sizes=ks,
        dilation_sizes=dss, resblock="1", num_groups=C // 16, interpret=True,
    ))
    tw, tb = _to_torch(weights, biases)
    before = profiling.total("k4.launches").count
    out = rb.resblock_tower_gn(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))), tw, tb,
        torch.from_numpy(scs), torch.from_numpy(gbs), kernel_sizes=ks, dilation_sizes=dss,
        resblock="1", num_groups=C // 16,
    )
    assert profiling.total("k4.launches").count == before
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1), ref, atol=3e-5)


def test_moments_order():
    """``moments`` lays out m_g then q_gh in the Pallas kernel's order."""
    rs = [torch.full((1, 2, 3), float(v)) for v in (1, 2, 3)]
    mom = rb.moments(rs)
    expected = [3, 6, 9, 1 * 1 * 3, 1 * 2 * 3, 1 * 3 * 3, 2 * 2 * 3, 2 * 3 * 3, 3 * 3 * 3]
    assert mom.shape == (1, 2, 9)
    np.testing.assert_array_equal(mom[0, 0].numpy(), np.asarray(expected, np.float32))


@pytest.mark.parametrize(
    "C,H,post,itemsize,acc,expected_tt",
    [
        (64, 63, 3, 2, True, 130),   # generator s2 width, 2-byte storage: one 256-column strip
        (32, 63, 3, 2, True, 386),   # s3: two strips keep all 8 warps busy
        (64, 63, 3, 4, True, 130),   # f32 still fits the 227 KB opt-in
        (64, 60, 0, 2, False, 136),  # encoder s0 (K4)
        (128, 60, 0, 2, False, 136), # bf16 C 128, which the tensor-core path does not take
        (48, 60, 0, 2, False, 136),  # bf16 C 48 likewise
        (8, 2, 0, 4, True, 1812),    # narrow and shallow: the widest window that fits, not whole strips
    ],
)
def test_pick_tile(C, H, post, itemsize, acc, expected_tt):
    """The FMA path's tile: whole 256-column strips where they fit."""
    tt, smem = rb.pick_tile(C, H, post, itemsize, acc)
    assert tt == expected_tt and tt >= 16
    assert smem <= 227 * 1024
    assert rb.row_stride(tt + 2 * H) % 8 == 0
    if C >= 32:
        assert (tt + 2 * H) % rb.STRIP == 0


RB1_ENC = ("1", (11, 7, 3), ((1, 3, 5),) * 3)


@pytest.mark.parametrize(
    "C,rbk,post,gn,expected",
    [
        (64, RB1, 0, False, (224, 344, 1)),      # generator s2, as chip_smoke.py prints it
        (32, RB1, 3, False, (240, 366, 2)),      # generator s3 with conv_post
        (64, RB1_ENC, 0, True, (224, 344, 1)),   # encoder s0 (K4)
        (16, RB1, 3, False, None),
        (32, RB1_ENC, 0, True, None),
        (64, RB2, 0, False, None),
        (16, RB2, 1, True, None),
        (64, ("1", (3,), ((1,),)), 0, False, None),  # one shallow chain: the row cap, not memory, binds
    ],
)
def test_pick_tile_tc(C, rbk, post, gn, expected):
    """The tensor-core path's tile: fits its shared-memory budget and row cap,
    at least 16 output columns in multiples of 8, every chain started at its
    own halo so that all of them end on the same centre."""
    resblock, ks, dss = rbk
    geo = rb.pick_tile_tc(C, ks, dss, resblock, post, gn)
    halos = rb.chain_halos(ks, dss, resblock)
    Hc = max(halos)
    assert geo.TT >= 16 and geo.TT % 8 == 0
    assert geo.H == Hc + post and geo.W == geo.TT + 2 * geo.H <= rb.TC_MAX_ROWS[C]
    assert geo.smem <= rb.TC_SMEM_BUDGET[C] <= 227 * 1024
    assert geo.blocks_per_sm * geo.smem <= 228 * 1024 - 1024 * geo.blocks_per_sm
    assert geo.buf % 1024 == 0 and geo.buf >= (geo.W + rb.TC_PAD_ROWS) * 2 * C
    assert len(geo.starts) == len(ks)
    for start, halo in zip(geo.starts, halos):
        assert start >= 0 and start + halo == Hc  # the chain's last conv lands on [Hc, W - Hc)
    if gn:
        n_mom = len(ks) + len(ks) * (len(ks) + 1) // 2
        assert 2 * geo.buf >= 2048 * n_mom  # the moments' scratch lies over two windows
    assert 1.0 < geo.cost < 4.0
    if expected is not None:
        assert (geo.TT, geo.W, geo.blocks_per_sm) == expected


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_pack_taps_roundtrip(C, k):
    """``pack_taps`` lays a weight out as k swizzled ``[C_out][C_in]`` tap tiles;
    ``unpack_taps`` gives the ``[O, I, K]`` weight back. Element (co, ci) of a
    tile sits in 16-byte chunk ``ci // 8 ^ (line & mask)`` of its row, with
    ``line`` the 128-byte line of the row."""
    w = torch.arange(C * C * k, dtype=torch.float32).reshape(C, C, k)
    flat = rb.pack_taps(w)
    assert flat.shape == (k * C * C,)
    assert torch.equal(rb.unpack_taps(flat, C, k), w)
    mask = C // 8 - 1
    for j, co, ci in ((0, 0, 0), (k - 1, C - 1, C - 1), (k // 2, 5, 9), (1, C // 2 + 3, 8)):
        line = co * 2 * C // 128
        chunk = (ci // 8) ^ (line & mask)
        assert flat[j * C * C + co * C + chunk * 8 + ci % 8].item() == w[co, ci, j].item()
    assert sorted(rb.swizzle_perm(C).tolist()) == list(range(C * C))


def _gn_recombine_one_function(rs, mom, gn_scales, gn_biases, num_groups, epsilon):
    """Pass 2 as one function (the JAX algebra, academicodec_tpu/ops/pallas/
    resblock.py:585-631), to hold ``gn_affines`` + ``gn_apply`` against."""
    G = len(rs)
    B, C, T = rs[0].shape
    m = [mom[:, :, g] for g in range(G)]
    q, col = {}, G
    for g in range(G):
        for h in range(g, G):
            q[(g, h)] = q[(h, g)] = mom[:, :, col]
            col += 1
    gsize = C // num_groups
    N = float(gsize * T)

    def gsum(v):
        s = v.reshape(B, num_groups, gsize).sum(dim=2, keepdim=True)
        return s.expand(B, num_groups, gsize).reshape(B, C)

    zeros = torch.zeros((B, C))
    A, K = [zeros for _ in range(G)], zeros
    for g in range(G):
        A[g] = A[g] + 1.0
        S = K * T
        for h in range(G):
            S = S + A[h] * m[h]
        Q = K * K * T
        for h in range(G):
            Q = Q + 2.0 * K * A[h] * m[h]
            for l in range(G):
                Q = Q + A[h] * A[l] * q[(h, l)]
        mu = gsum(S) / N
        var = gsum(Q) / N - mu * mu
        a = gn_scales[g].float() * torch.rsqrt(var + epsilon)
        b = gn_biases[g].float() - mu * a
        A = [a * Ah for Ah in A]
        K = a * K + b
    inv = 1.0 / float(G)
    out = K[:, :, None] * inv
    for g in range(G):
        out = out + (A[g] * inv)[:, :, None] * rs[g].float()
    return out.to(rs[0].dtype)


@pytest.mark.parametrize("G,C,T,dtype", [(3, 32, 97, torch.float32), (2, 16, 40, torch.float32),
                                         (3, 64, 50, torch.bfloat16)])
def test_gn_affines_and_apply_compose_to_recombine(G, C, T, dtype):
    """``gn_recombine`` = ``gn_apply(gn_affines(...))``, bit for bit the
    one-function form; ``A`` is ``[G, B, C]`` and ``K`` ``[B, C]`` in f32."""
    rng = np.random.default_rng(G * C)
    rs = [torch.from_numpy(rng.standard_normal((2, C, T)).astype(np.float32)).to(dtype) for _ in range(G)]
    scs = torch.from_numpy((rng.standard_normal((G, C)) * 0.3 + 1.0).astype(np.float32))
    gbs = torch.from_numpy((rng.standard_normal((G, C)) * 0.1).astype(np.float32))
    mom = rb.moments(rs)
    A, K = rb.gn_affines(mom, scs, gbs, C // 16, 1e-6, T)
    assert A.shape == (G, 2, C) and K.shape == (2, C) and A.dtype == K.dtype == torch.float32
    expected = _gn_recombine_one_function(rs, mom, scs, gbs, C // 16, 1e-6)
    assert torch.equal(rb.gn_apply(rs, A, K), expected)
    assert torch.equal(rb.gn_recombine(rs, mom, scs, gbs, C // 16, 1e-6), expected)


@pytest.mark.parametrize("post", [False, True])
def test_wrappers_take_packed_operands(post):
    """A ``PackedTower`` in place of the raw weights gives the same result
    (on the CPU: the plain version reads the weights it holds)."""
    rng = np.random.default_rng(5)
    resblock, ks, dss = RB1
    C = 16
    weights, biases = _to_torch(*_rand_tower(rng, ks, dss, resblock, C))
    x = torch.from_numpy((rng.standard_normal((2, C, 90)) * 0.5).astype(np.float32))
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock=resblock)
    pkw = {}
    if post:
        pkw = dict(post_weight=torch.from_numpy((rng.standard_normal((1, C, 7)) * 0.1).astype(np.float32)),
                   post_bias=torch.from_numpy(rng.standard_normal(1).astype(np.float32)))
    packed = rb.pack_tower(weights, biases, **kw, **pkw)
    assert packed.w_all is None and packed.C == C and not packed.tc  # nothing is packed for the CPU
    assert torch.equal(rb.resblock_tower(x, packed, post_tanh=post),
                       rb.resblock_tower(x, weights, biases, post_tanh=post, **kw, **pkw))
    scs, gbs = torch.ones((3, C)), torch.zeros((3, C))
    assert torch.equal(rb.resblock_tower_gn(x, packed, None, scs, gbs, num_groups=1),
                       rb.resblock_tower_gn(x, weights, biases, scs, gbs, num_groups=1, **kw))


def test_uses_tc():
    """bf16 with 16, 32 or 64 channels takes the tensor-core path; everything
    else the FMA path."""
    assert all(rb.uses_tc(torch.bfloat16, C) for C in (16, 32, 64))
    assert not any(rb.uses_tc(torch.bfloat16, C) for C in (8, 24, 48, 96, 128))
    assert not any(rb.uses_tc(torch.float32, C) for C in (16, 32, 64))


def test_cuda_wrapper_rejects_cpu_mixed_devices():
    """A CUDA call never reaches the plain version: a non-CPU set of tensors
    that is not all on one card raises before any launch."""
    x = torch.zeros((1, 8, 10), device="meta")
    w = [[torch.zeros((8, 8, 3))] * 2]
    b = [[torch.zeros(8)] * 2]
    with pytest.raises(ValueError, match="CUDA tensors"):
        rb.resblock_tower(x, w, b, kernel_sizes=(3,), dilation_sizes=((1,),), resblock="1")


def _tiny_generator():
    from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig, HiFiGANGenerator

    cfg = HiFiCodecConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=32,
                          encoder_base_channels=16, resblock_kernel_sizes=(3, 7),
                          resblock_dilation_sizes=((1, 3), (1, 3)))
    gen = HiFiGANGenerator(cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return gen, torch.randn((1, cfg.latent_dim, 12), generator=g)


def test_packed_stage_is_kept_between_calls():
    """Serving packs a fused stage's operands once: the second call reuses them."""
    gen, z = _tiny_generator()
    with torch.no_grad():
        y0 = gen(z)
        kept = [st.packed for st in gen._packed]
        y1 = gen(z)
    assert all(p is not None for p in kept)  # both stages are narrow enough to be fused
    assert all(st.packed is p for st, p in zip(gen._packed, kept))
    assert torch.equal(y0, y1)


def test_packed_stage_rebuilds_after_in_place_update():
    """An optimizer-style in-place update of one weight is seen by the next call."""
    gen, z = _tiny_generator()
    with torch.no_grad():
        y0 = gen(z)
        kept = [st.packed for st in gen._packed]
        gen.resblocks[0].convs1[0].weight_g.mul_(1.5)  # first stage only
        y1 = gen(z)
        fresh, _ = _tiny_generator()
        fresh.resblocks[0].convs1[0].weight_g.mul_(1.5)
        expected = fresh(z)
    assert gen._packed[0].packed is not kept[0] and gen._packed[1].packed is kept[1]
    assert not torch.equal(y0, y1) and torch.equal(y1, expected)


def test_packed_stage_rebuilds_after_cast_and_with_grad():
    """``.to(dtype)`` repacks in the new dtype; with gradients enabled nothing
    is kept and the weights stay differentiable."""
    gen, z = _tiny_generator()
    with torch.no_grad():
        gen(z)
        kept = [st.packed for st in gen._packed]
        gen.to(torch.bfloat16)
        y = gen(z.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert all(st.packed is not p and st.packed.dtype == torch.bfloat16 for st, p in zip(gen._packed, kept))
    gen.to(torch.float32)
    kept = [st.packed for st in gen._packed]
    out = gen(z)  # gradients enabled
    assert all(st.packed is p for st, p in zip(gen._packed, kept))  # untouched by the call
    out.sum().backward()
    assert gen.resblocks[0].convs1[0].weight_v.grad is not None


# ---------------------------------------------------------------- K3's convT prologue


@pytest.mark.parametrize("u,kT,post", [(4, 8, True), (2, 4, False)])
def test_tower_plain_pre_matches_pallas(monkeypatch, u, kT, post):
    """K3's prologue (lrelu -> phase-major ConvTranspose1d) feeding the
    tower, against the Pallas ``pre`` branch in interpret mode across its tile
    boundaries (the case of tests/test_pallas_resblock.py:114-136, and one
    with stride 2, k 4 and no post conv), f32."""
    monkeypatch.setattr(jrb, "_pick_tile", lambda C, H, u=1: 256)
    rng = np.random.default_rng(3 + u)
    resblock, ks, dss = RB1
    B, T_in, C_in, C = 1, 500, 16, 32
    z = (rng.standard_normal((B, T_in, C_in)) * 0.5).astype(np.float32)
    weights, biases = _rand_tower(rng, ks, dss, resblock, C)
    wT = (rng.standard_normal((kT, C_in, C)) * 0.1).astype(np.float32)
    bT = (rng.standard_normal(C) * 0.1).astype(np.float32)
    jkw = dict(pre_kernel=jnp.asarray(wT), pre_bias=jnp.asarray(bT), pre_stride=u, pre_pad=(kT - u) // 2)
    tkw = dict(pre_weight=torch.from_numpy(np.ascontiguousarray(wT.transpose(1, 2, 0))),
               pre_bias=torch.from_numpy(bT), pre_stride=u, pre_pad=(kT - u) // 2)
    if post:
        wp = (rng.standard_normal((7, C, 1)) * 0.1).astype(np.float32)
        bp = (rng.standard_normal(1) * 0.1).astype(np.float32)
        jkw.update(post_kernel=jnp.asarray(wp), post_bias=jnp.asarray(bp), post_tanh=True)
        tkw.update(post_weight=torch.from_numpy(np.ascontiguousarray(wp.transpose(2, 1, 0))),
                   post_bias=torch.from_numpy(bp), post_tanh=True)
    jw, jb = _to_jax(weights, biases)
    ref = np.asarray(jrb.resblock_tower(jnp.asarray(z), jw, jb, kernel_sizes=ks, dilation_sizes=dss,
                                        resblock=resblock, interpret=True, **jkw))
    tw, tb = _to_torch(weights, biases)
    before = profiling.total("k3.launches").count
    out = rb.resblock_tower(torch.from_numpy(np.ascontiguousarray(z.transpose(0, 2, 1))), tw, tb,
                            kernel_sizes=ks, dilation_sizes=dss, resblock=resblock, **tkw)
    assert profiling.total("k3.launches").count == before
    assert out.shape == (B, 1 if post else C, T_in * u)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1), ref, atol=2e-5)


@pytest.mark.parametrize("k,u", [(16, 8), (11, 5), (8, 4), (4, 2), (3, 1)])
def test_convt_phase_taps_match_jax(k, u):
    from academicodec_tpu.ops.conv import convt_phase_taps as jtaps

    assert rb.convt_phase_taps(k, u, (k - u) // 2) == jtaps(k, u, (k - u) // 2)


@pytest.mark.parametrize("C,C_in,u,kT,post,dtype", [
    (64, 128, 4, 8, False, torch.bfloat16),  # hificodec_24k_320d generator stage 2
    (32, 64, 2, 4, True, torch.bfloat16),    # stage 3 with conv_post
    (32, 64, 2, 4, True, torch.float32),     # the FMA path
    (16, 40, 8, 16, False, torch.bfloat16),  # C_in not a multiple of C: the FMA path
])
def test_pre_tile_geometry(C, C_in, u, kT, post, dtype):
    """With the prologue the halo and the tile are multiples of the stride (a
    tile's window starts on a phase boundary), each phase's rows fit two
    m-tiles a warp, and the input window's slices fit one window buffer."""
    resblock, ks, dss = RB1
    P = 3 if post else 0
    packed = rb.PackedTower([], [], ks, dss, resblock, torch.zeros((1, C, 7)) if post else None, None, dtype,
                            torch.device("cuda"), C, torch.zeros((C_in, C, kT)), None, u, (kT - u) // 2)
    packed.tc = rb.uses_tc(dtype, C) and C_in % C == 0
    packed.wp = packed.post_weight
    _, m_hi, m_lo = rb._pre_spec(packed.pre_weight, C, u, (kT - u) // 2)
    if packed.tc:
        packed.pre_geo = rb.PreGeometry(u, C_in // C, m_hi - m_lo, kT // u * (C_in // C) * u)
    TT, H, Hc, buf, smem = rb.tower_geometry(packed, gn=False)
    assert H % u == 0 and TT % u == 0 and H >= Hc + P and H - (Hc + P) < u
    if packed.tc:
        W = TT + 2 * H
        assert W // u <= 256 and buf >= packed.pre_geo.n_half * rb.pre_slice_bytes(C, W // u, m_hi - m_lo)
        assert smem <= rb.TC_SMEM_BUDGET[C]


def test_pack_tower_checks_the_prologue():
    resblock, ks, dss = RB1
    weights, biases = _to_torch(*_rand_tower(np.random.default_rng(0), ks, dss, resblock, 16))
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock=resblock)
    with pytest.raises(ValueError, match="pad"):
        rb.pack_tower(weights, biases, pre_weight=torch.zeros((32, 16, 8)), pre_stride=4, pre_pad=1, **kw)
    with pytest.raises(ValueError, match="pre weight"):
        rb.pack_tower(weights, biases, pre_weight=torch.zeros((32, 8, 8)), pre_stride=4, pre_pad=2, **kw)
    p = rb.pack_tower(weights, biases, pre_weight=torch.zeros((32, 16, 8)), pre_stride=4, pre_pad=2, **kw)
    assert p.C_in == 32 and p.C == 16


# ---------------------------------------------------------------- K4 with lengths


def _k4_case(seed, B, C, T, ks, dss):
    rng = np.random.default_rng(seed)
    G = len(ks)
    weights, biases = _to_torch(*_rand_tower(rng, ks, dss, "1", C))
    scs = torch.from_numpy((rng.standard_normal((G, C)) * 0.3 + 1.0).astype(np.float32))
    gbs = torch.from_numpy((rng.standard_normal((G, C)) * 0.1).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((B, C, T)) * 0.3).astype(np.float32))
    return weights, biases, scs, gbs, x


def test_gn_tower_plain_lengths_equal_exact_length_calls():
    """Each row of a padded call with lengths equals that row alone at its
    exact length; pad frames are exactly 0 (even where the input is not)."""
    ks, dss = (11, 7, 3), ((1, 3, 5),) * 3
    weights, biases, scs, gbs, x = _k4_case(12, 3, 32, 300, ks, dss)
    kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock="1", num_groups=2)
    lengths = [300, 177, 60]
    out = rb.resblock_tower_gn(x, weights, biases, scs, gbs, lengths=torch.tensor(lengths), **kw)
    for b, L in enumerate(lengths):
        alone = rb.resblock_tower_gn(x[b:b + 1, :, :L].contiguous(), weights, biases, scs, gbs, **kw)
        np.testing.assert_allclose(out[b, :, :L].numpy(), alone[0].numpy(), atol=1e-5)
        assert torch.count_nonzero(out[b, :, L:]) == 0
    full = rb.resblock_tower_gn(x, weights, biases, scs, gbs, **kw)
    assert torch.equal(rb.resblock_tower_gn(x, weights, biases, scs, gbs, lengths=[300] * 3, **kw), full)


def test_gn_tower_plain_lengths_match_the_unfused_masked_stage():
    """The masked K4 plain version equals the port's unfused masked stage
    (ResBlock1 with a mask, GroupNormTorch over the masked padded layout, JAX
    nn/hifigan.py:151-184, 239-280) on the same weights."""
    from academicodec_tpu_torch.nn.hifigan import GroupNormTorch, Padded, ResBlock1

    ks, dss = (11, 7, 3), ((1, 3, 5),) * 3
    C, T = 32, 260
    blocks = [ResBlock1(C, k, ds, norm="none") for k, ds in zip(ks, dss)]
    norms = [GroupNormTorch(C // 16, C) for _ in ks]
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in [*blocks, *norms]:
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.1 + (1.0 if p.dim() == 1 and m in norms else 0.0))
    L = torch.tensor([260, 131])
    mask = rb.frame_mask(L, T).float()
    x = torch.randn((2, C, T), generator=g) * 0.3 * mask
    xs = None
    with torch.no_grad():
        for blk, gn in zip(blocks, norms):
            r = blk(x, mask)
            xs = gn(r if xs is None else xs + r, Padded(L, None, x)) * mask
        ref = xs / len(ks)
        ws, bs = zip(*(blk.weights_and_biases() for blk in blocks))
        out = rb.resblock_tower_gn(x, ws, bs, torch.stack([n.weight for n in norms]),
                                   torch.stack([n.bias for n in norms]), kernel_sizes=ks, dilation_sizes=dss,
                                   num_groups=C // 16, lengths=L)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-5)


def test_gn_affines_counts_equal_scalar_length():
    """A ``[B]`` tensor of counts all equal to T gives the scalar-T affines bit for bit."""
    rng = np.random.default_rng(2)
    rs = [torch.from_numpy(rng.standard_normal((2, 32, 97)).astype(np.float32)) for _ in range(3)]
    scs = torch.from_numpy((rng.standard_normal((3, 32)) * 0.3 + 1.0).astype(np.float32))
    gbs = torch.from_numpy((rng.standard_normal((3, 32)) * 0.1).astype(np.float32))
    mom = rb.moments(rs)
    A, K = rb.gn_affines(mom, scs, gbs, 2, 1e-6, 97)
    A2, K2 = rb.gn_affines(mom, scs, gbs, 2, 1e-6, torch.tensor([97, 97], dtype=torch.int32))
    assert torch.equal(A, A2) and torch.equal(K, K2)


def test_packed_stage_with_fused_pre_rebuilds_after_an_ups_update():
    """With ``fused_pre`` a stage's packed operands hold its upsampling convT:
    an in-place update of that weight is seen by the next call, and turning
    ``fused_pre`` off and on repacks."""
    gen, z = _tiny_generator()
    with torch.no_grad():
        y0 = gen(z)
        gen.fused_pre = True
        assert torch.allclose(gen(z), y0, atol=1e-6)
        kept = [st.packed for st in gen._packed]
        assert all(p.pre_weight is not None for p in kept)
        gen.ups[0].weight_g.mul_(1.5)
        y1 = gen(z)
        fresh, _ = _tiny_generator()
        fresh.ups[0].weight_g.mul_(1.5)
        expected = fresh(z)
    assert gen._packed[0].packed is not kept[0] and gen._packed[1].packed is kept[1]
    assert torch.allclose(y1, expected, atol=1e-6) and not torch.allclose(y1, y0, atol=1e-6)


@pytest.mark.parametrize("C,rbk,expected", [
    (64, RB1_ENC, (312, 432, 221440)),  # the encoder's stage 0 (hificodec_24k_320d), as the kernel runs it
    (32, RB1_ENC, (752, 872, 223744)),
    (16, RB1_ENC, (1680, 1800, 231424)),
    (64, RB2, None),
    (32, ("1", (5, 3), ((1, 2), (1, 3))), None),  # k 5: the runtime tap loop
    (16, ("1", (3,), ((1,),)), None),  # one shallow chain: the window is capped by the lanes, not memory
])
def test_pick_tile_fma_gn(C, rbk, expected):
    """K4's f32 FMA path at C 16/32/64: TT a multiple of 8 (at least 16 and
    GN_NT_MIN - 1 spans), the window within GN_NT_MAX spans and shared memory,
    every conv's range inside
    the NT spans it computes (NT from 4 to 8, each chain at its own halo), and
    at the encoder's stage 0 fewer columns computed per output than today's kernel."""
    resblock, ks, dss = rbk
    geo = rb.pick_tile_fma_gn(C, ks, dss, resblock)
    halos = rb.chain_halos(ks, dss, resblock)
    span = rb.fma_gn_span(C)
    assert span * (C // rb.CO_TILE) == 32 * rb.FMA_GN_WARPS
    assert geo.TT >= 16 and geo.TT % 8 == 0 and geo.H == max(halos) and geo.W == geo.TT + 2 * geo.H
    assert (rb.FMA_GN_NT[0] - 1) * span <= geo.TT and geo.W <= rb.FMA_GN_NT[1] * span  # reads within a row + a span
    assert geo.smem == rb.fma_gn_smem(C, geo.W) == (2 * C * rb.row_stride(geo.W) + span) * 4 <= 227 * 1024
    i = 0
    for k, ds, h in zip(ks, dss, halos):
        lo, hi = geo.H - h, geo.W - (geo.H - h)
        for d in rb.chain_conv_dilations(ds, resblock):
            lo, hi = lo + (k - 1) // 2 * d, hi - (k - 1) // 2 * d
            assert rb.FMA_GN_NT[0] <= geo.nts[i] <= rb.FMA_GN_NT[1] and geo.nts[i] * span >= hi - lo
            i += 1
        assert (lo, hi) == (geo.H, geo.H + geo.TT)  # every chain ends on the centre
    assert i == len(geo.nts)
    if expected is not None:
        assert (geo.TT, geo.W, geo.smem) == expected
        old_tt, _ = rb.pick_tile(C, geo.H, 0, 4, with_acc=False)  # a conv of today's kernel: whole strips
        assert geo.cost < min(1.25, (old_tt + 2 * geo.H + rb.STRIP - 1) // rb.STRIP * rb.STRIP / old_tt)


@pytest.mark.parametrize("dtype,C,gn,path", [
    (torch.float32, 64, True, "fma_gn"), (torch.float32, 16, True, "fma_gn"),
    (torch.float32, 48, True, "fma"),    # other widths keep today's kernel
    (torch.float32, 64, False, "fma"),   # K3 keeps today's FMA kernel
    (torch.bfloat16, 64, True, "tc"), (torch.bfloat16, 128, True, "fma"),
])
def test_tower_geometry_picks_the_k4_path(dtype, C, gn, path):
    """``tower_geometry`` (and so ``gn_tile``) takes the tile of the kernel the
    C entry point dispatches to: f32 K4 at C 16/32/64 -> gn_tower_fma_kernel_c."""
    resblock, ks, dss = RB1_ENC
    packed = rb.PackedTower([], [], ks, dss, resblock, None, None, dtype, torch.device("cuda"), C)
    packed.tc = rb.uses_tc(dtype, C)
    TT, H, Hc, buf, smem = rb.tower_geometry(packed, gn=gn)
    assert rb.uses_fma_gn(dtype, C) == (dtype == torch.float32 and C in (16, 32, 64))
    expect = {
        "fma_gn": lambda: rb.pick_tile_fma_gn(C, ks, dss, resblock).TT,
        "fma": lambda: rb.pick_tile(C, H, 0, 2 if dtype == torch.bfloat16 else 4, with_acc=not gn)[0],
        "tc": lambda: rb.pick_tile_tc(C, ks, dss, resblock, 0, gn).TT,
    }[path]()
    assert TT == expect and H == Hc == 60
    if gn:
        assert rb.gn_tile(packed) == TT


def _tiles_brute(lengths, B, T, TT):
    nT = -(-T // TT)
    if lengths is None:
        return B * nT, 0
    return B * nT, sum(1 for n in lengths for t in range(nT) if t * TT >= min(max(int(n), 0), T))


@pytest.mark.parametrize("T,TT,lengths", [
    (1000, 312, [0, 312, 624, 500]),       # length 0, two ending on a tile boundary, one inside a tile
    (1000, 312, [1000, 999, 1, 313]),      # full T (not a multiple of TT), one frame short, one frame, one past
    (936, 312, [936, 935, -5, 2000]),      # T a multiple of TT; lengths clamped to [0, T]
    (120000, 312, None),                   # no lengths: nothing past them
    (50, 312, [50, 0, 17]),                # one tile shorter than TT
])
def test_k4_tiles_counts_the_tiles_past_each_length(T, TT, lengths):
    """``k4_tiles``: a row's tiles from ceil(length / TT) on start at or past its
    length (the tiles gn_tower_fma_kernel_c skips), lengths clamped to [0, T]."""
    B = 4 if lengths is None else len(lengths)
    assert rb.k4_tiles(lengths, B, T, TT) == _tiles_brute(lengths, B, T, TT)
    if lengths is not None:
        assert rb.k4_tiles(torch.tensor(lengths), B, T, TT) == _tiles_brute(lengths, B, T, TT)


@pytest.mark.parametrize("k,u", [(4, 2), (8, 4), (11, 5), (16, 8), (3, 1)])
def test_strided_length_is_the_strided_convs_output_length(k, u):
    """``strided_length``: an encoder stage's strided conv (padding (k - u) // 2)
    maps n valid samples to this many valid frames, ints and tensors alike."""
    from academicodec_tpu_torch.nn.hifigan import strided_length

    ns = [k, k + 1, 97, 1000, 1001, 240000]
    got = strided_length(torch.tensor(ns), k, u)
    for n, g in zip(ns, got.tolist()):
        want = torch.nn.functional.conv1d(torch.zeros(1, 1, n), torch.zeros(1, 1, k), stride=u,
                                          padding=(k - u) // 2).shape[-1]
        assert strided_length(n, k, u) == g == want


def test_count_tiles_reads_host_lengths_only():
    """``count_tiles`` adds a launch's tiles and, where the kernel skips them, the
    tiles past the lengths, from host lengths (the tokenization cell's 16 clips
    through the encoder's stage-0 conv: 2152 of 6160 tiles at TT 312); lengths
    on a device, which it would have to wait for, count nothing."""
    from academicodec_tpu_torch.nn.hifigan import strided_length

    clips = [int(round(24000 * (3.0 + 7.0 * (i + 0.5) / 16))) for i in range(16)]  # 3-10 s, evenly spaced
    L = [strided_length(n, 4, 2) for n in clips]
    names = ("k4.tiles", "k4.tiles_skipped")
    profiling.reset(*names)
    rb.count_tiles(L, 16, 120000, 312, skips=True)
    assert [profiling.total(n).count for n in names] == list(_tiles_brute(L, 16, 120000, 312)) == [6160, 2152]
    rb.count_tiles(torch.tensor(L), 16, 120000, 312, skips=False)  # a kernel that runs every tile
    rb.count_tiles(None, 16, 120000, 312, skips=True)
    assert [profiling.total(n).count for n in names] == [3 * 6160, 2152]
    rb.count_tiles(torch.tensor(L, device="meta"), 16, 120000, 312, skips=True)
    assert [profiling.total(n).count for n in names] == [3 * 6160, 2152]
    assert rb.on_host(L) and rb.on_host(torch.tensor(L)) and not rb.on_host(torch.tensor(L, device="meta"))
    assert torch.equal(rb.clamp_lengths(L + [0], 17, 100000, "cpu"),
                       torch.tensor([min(v, 100000) for v in L] + [0], dtype=torch.int32))


def test_encoder_hands_k4_the_host_lengths(monkeypatch):
    """``HiFiGANEncoder.forward`` with host lengths gives K4 its stage's lengths
    on the host (through the strided conv's formula), so that K4 counts its
    tiles without waiting for the device; lengths on a device reach K4 as they are."""
    from academicodec_tpu_torch.nn import hifigan

    seen = []
    real = hifigan.resblock_tower_gn

    def spy(x, *args, lengths=None, **kw):
        seen.append(lengths)
        return real(x, *args, lengths=lengths, **kw)

    monkeypatch.setattr(hifigan, "resblock_tower_gn", spy)
    cfg = hifigan.HiFiCodecConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=32,
                                  resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),),
                                  encoder_base_channels=8)
    enc = hifigan.HiFiGANEncoder(cfg, norm="none")
    x = torch.randn(2, 1, 400)
    with torch.no_grad():
        enc(x, [400, 123])
    assert len(seen) == 2  # both stages: 16 and 32 channels
    want = [400, 123]
    for got in seen:
        want = [hifigan.strided_length(n, 4, 2) for n in want]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu" and got.tolist() == want
