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
    before = rb.TOWER_LAUNCHES
    ref, out = _run_both(x, weights, biases, resblock, ks, dss, dtype=dtype)
    assert rb.TOWER_LAUNCHES == before  # CPU tensors run the plain version
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
    before = rb.GN_TOWER_LAUNCHES
    out = rb.resblock_tower_gn(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))), tw, tb,
        torch.from_numpy(scs), torch.from_numpy(gbs), kernel_sizes=ks, dilation_sizes=dss,
        resblock="1", num_groups=C // 16,
    )
    assert rb.GN_TOWER_LAUNCHES == before
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
        (64, 63, 3, 2, True, 130),   # generator s2 width, bf16: one 256-column strip
        (32, 63, 3, 2, True, 386),   # s3: two strips keep all 8 warps busy
        (64, 63, 3, 4, True, 130),   # f32 still fits the 227 KB opt-in
        (64, 60, 0, 2, False, 136),  # encoder s0 (K4)
    ],
)
@pytest.mark.parametrize("mma", [False, True])
def test_pick_tile(C, H, post, itemsize, acc, expected_tt, mma):
    mma = mma and itemsize == 2  # the tensor-core path is bf16 only
    tt, smem = rb.pick_tile(C, H, post, itemsize, acc, mma=mma)
    assert tt == expected_tt and (tt + 2 * H) % rb.STRIP == 0
    assert smem <= 227 * 1024
    assert rb.row_stride(tt + 2 * H, mma) % 64 == (8 if mma else 0)


def test_fragment_order():
    """``_fragment_order`` lays a weight out as mma.sync m16n8k16 A fragments:
    lane 4 gid + tig holds rows gid, gid + 8 and columns 2 tig (+1), 2 tig + 8 (+1)."""
    O = I = 32
    K = 2
    w = torch.arange(O * I * K, dtype=torch.float32).reshape(O, I, K)
    f = rb._fragment_order(w).reshape(K, O // 16, I // 16, 32, 8)
    for j, mt, kt, lane in ((0, 0, 0, 0), (1, 1, 0, 13), (0, 1, 1, 31)):
        gid, tig = lane >> 2, lane & 3
        expected = [w[mt * 16 + gid + 8 * rh, kt * 16 + 2 * tig + p + 8 * ch, j].item()
                    for ch in range(2) for rh in range(2) for p in range(2)]
        assert f[j, mt, kt, lane].tolist() == expected


def test_cuda_wrapper_rejects_cpu_mixed_devices():
    """A CUDA call never reaches the plain version: a non-CPU set of tensors
    that is not all on one card raises before any launch."""
    x = torch.zeros((1, 8, 10), device="meta")
    w = [[torch.zeros((8, 8, 3))] * 2]
    b = [[torch.zeros(8)] * 2]
    with pytest.raises(ValueError, match="CUDA tensors"):
        rb.resblock_tower(x, w, b, kernel_sizes=(3,), dilation_sizes=((1,),), resblock="1")
