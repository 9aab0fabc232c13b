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
from academicodec_tpu_torch.ops.cuda import resblock as rb
from academicodec_tpu_torch.probes import int8_chain

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
    before = chain.P1_LAUNCHES
    got = chain.conv_chain_bf16(_bf16(x), chain.pack_chain_bf16(torch.from_numpy(w), torch.from_numpy(b)))
    assert chain.P1_LAUNCHES == before and got.dtype == torch.bfloat16 and got.shape == (C, TT)
    assert np.abs(got.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("C,TT", [(16, 256), (32, 384), (64, 256), (32, 12), (64, 5)])
def test_p2_plain_matches_the_pallas_kernel(C, TT):
    x, w, b = _inputs(C, TT, 2 * C + TT)
    cal = _jax_calibration(x, w, b)
    ref = _jax_p2(x, cal["wq"], cal["ws"], b, cal["s_act"])
    before = chain.P2_LAUNCHES
    ops = chain.pack_chain_i8(*(torch.from_numpy(cal[k]) for k in ("wq", "ws")), torch.from_numpy(b),
                              torch.from_numpy(cal["s_act"]))
    got = chain.conv_chain_i8(_bf16(x), ops).float().numpy()
    assert chain.P2_LAUNCHES == before
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
    before = chain.P1_LAUNCHES, chain.P2_LAUNCHES
    assert torch.equal(chain.conv_chain_bf16(xt, chain.pack_chain_bf16(wt, bt)),
                       chain.conv_chain_bf16_plain(xt, wt, bt))
    assert torch.equal(chain.conv_chain_i8(xt, chain.pack_chain_i8(*q)), chain.conv_chain_i8_plain(xt, *q))
    assert (chain.P1_LAUNCHES, chain.P2_LAUNCHES) == before
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


@pytest.mark.parametrize("C", [32, 64])
def test_tap_packing(C):
    """bf16 tiles are ``resblock.pack_taps`` of each conv; int8 tiles unswizzle
    (the permutation is an involution) to the tap blocks ``W[p][:, jC:(j+1)C]``."""
    w = torch.from_numpy(_inputs(C, 8, C)[1])
    wb = w.to(torch.bfloat16)
    expected = torch.cat([rb.pack_taps(wb[p].view(C, K, C).permute(0, 2, 1)) for p in range(P)])
    assert torch.equal(chain.pack_taps_chain(wb), expected)
    perm = chain.swizzle_perm_i8(C)
    assert torch.equal(perm[perm], torch.arange(C * C))
    wq, _ = chain.quantize_weights(w)
    tiles = chain.pack_taps_chain(wq).view(P * K, C * C)[:, perm].view(P, K, C, C)
    for p in range(P):
        for j in range(K):
            assert torch.equal(tiles[p, j], wq[p][:, j * C:(j + 1) * C])


def test_tile_geometry():
    """Windows of at most 384 rows, tiles a multiple of 8 that fill the SMs on
    short sequences; the block fits its shared-memory budget (all of an SM at C
    64, half at C 32, where two blocks share one)."""
    for B, C, T in ((8, 64, 120000), (8, 32, 240000), (1, 64, 8192), (1, 32, 4096), (2, 64, 5)):
        tt = chain.chain_tile(B, T, P, C, 132)
        assert tt % 8 == 0 and 16 <= tt and tt + 6 * P <= chain.MAX_ROWS
        if B * -(-T // 344) < 132 * (1 if C == 64 else 2) and T > 16 * 132:
            assert B * -(-T // tt) >= 128
        for itemsize in (1, 2):
            assert chain.chain_smem_bytes(C, itemsize, tt, P) <= (227 if C == 64 else 113) * 1024
    assert chain.chain_tile(8, 120000, P, 64, 132) == 344


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
    before = chain.P1_LAUNCHES, chain.P2_LAUNCHES
    assert int8_chain.main(["--device", "cpu", "--tiny"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows[0] == {"device": "cpu"} and len(rows) == 1 + 4 + 2 + 1
    for r in rows[1:5]:
        assert {"C", "TT", "bf16_ms", "i8_ms", "ratio", "err_bf16", "err_i8", "bound_bf16_ms", "bound_i8_ms"} <= set(r)
        assert r["bf16_ms"] is None and r["p2_bitwise"] and r["err_i8"] < 0.1
    assert [r["shape"] for r in rows[5:7]] == ["s2", "s3"]
    assert rows[-1]["decision"] == "not taken: no device time"
    assert (chain.P1_LAUNCHES, chain.P2_LAUNCHES) == before


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
