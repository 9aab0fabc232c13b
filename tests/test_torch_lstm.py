"""The port's LSTM recurrence (plain K2 and SLSTM) against the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from academicodec_tpu.nn.lstm import SLSTM as JSLSTM
from academicodec_tpu.ops.pallas.lstm import lstm2_fused

from academicodec_tpu_torch.nn.lstm import SLSTM
from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES
from academicodec_tpu_torch.ops.cuda.lstm import lstm2, lstm2_geometry, lstm2_plain, lstm2_smem_bytes
from academicodec_tpu_torch.utils.convert import slstm_state_from_jax


def _jax_slstm(dim, B, T, skip, seed):
    x = (np.random.default_rng(seed).standard_normal((B, T, dim)) * 0.5).astype(np.float32)
    mod = JSLSTM(dimension=dim, num_layers=2, skip=skip)
    variables = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return mod, variables, x


def test_lstm2_plain_bf16_matches_interpreted_pallas_kernel():
    """bf16 weights: the plain version rounds h and W to bf16 and multiplies
    in f32, as the Pallas kernel does (preferred_element_type=f32). Only the
    summation order differs: the largest difference seen is 6e-8, held to 1e-6."""
    dim, B, T = 64, 2, 70
    _, variables, x = _jax_slstm(dim, B, T, skip=False, seed=0)
    p = variables["params"]
    l0, l1 = p["l0"], p["l1"]
    ref = np.asarray(lstm2_fused(
        jnp.asarray(x), l0["weight_ih"], l0["weight_hh"], l0["bias_ih"] + l0["bias_hh"],
        l1["weight_ih"], l1["weight_hh"], l1["bias_ih"] + l1["bias_hh"], chunk=32, interpret=True,
    ))

    port = SLSTM(dim, skip=False)
    port.load_state_dict(slstm_state_from_jax(p))
    with torch.no_grad():
        x_proj, w_hh1, w_ih2, w_hh2, b2 = port.recurrence_inputs(torch.from_numpy(x.transpose(0, 2, 1)))
        bf = torch.bfloat16
        y = lstm2_plain(x_proj, w_hh1.to(bf), w_ih2.to(bf), w_hh2.to(bf), b2, out_dtype=torch.float32)
    np.testing.assert_allclose(y.transpose(0, 1).numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("skip", [True, False])
def test_slstm_f32_matches_jax_scan(skip):
    dim, B, T = 32, 2, 40
    mod, variables, x = _jax_slstm(dim, B, T, skip=skip, seed=1)
    ref = np.asarray(jax.jit(mod.apply)(variables, jnp.asarray(x)))
    port = SLSTM(dim, skip=skip)
    port.load_state_dict(slstm_state_from_jax(variables["params"]))
    with torch.no_grad():
        y = port(torch.from_numpy(x.transpose(0, 2, 1))).numpy()
    np.testing.assert_allclose(y.transpose(0, 2, 1), ref, atol=1e-5, rtol=0)


def test_lstm2_wrapper_takes_plain_version_on_cpu_and_checks_devices():
    g = torch.Generator().manual_seed(0)
    T, B, H = 5, 2, 8
    args = (torch.randn(T, B, 4 * H, generator=g), *(torch.randn(4 * H, H, generator=g) for _ in range(3)),
            torch.randn(4 * H, generator=g))
    torch.testing.assert_close(lstm2(*args, out_dtype=torch.float32),
                               lstm2_plain(*args, out_dtype=torch.float32), rtol=0, atol=0)
    with pytest.raises(ValueError):
        lstm2(args[0].to("meta"), *args[1:], out_dtype=torch.float32)


def test_slstm_is_two_layers_only():
    with pytest.raises(ValueError):
        SLSTM(8, num_layers=3)


@pytest.mark.parametrize(
    "B,H,itemsize,sms,expected",
    [
        # the flagship call on an H100: 4 units a block, 128 blocks, 48 KB of bf16 weights
        (8, 512, 2, 132, (4, 128, 3 * 16 * 512 * 2 + 4 * 8 * (12 * 16 + 16 + 8) + 4 * 16)),
        (8, 512, 4, 132, (4, 128, 3 * 16 * 516 * 4 + 4 * 8 * (12 * 16 + 16 + 8) + 4 * 16)),
        (8, 512, 2, 114, (8, 64, 3 * 32 * 512 * 2 + 4 * 8 * (12 * 32 + 32 + 16) + 4 * 32)),  # fewer SMs
        (8, 600, 2, 132, (8, 75, 3 * 32 * 608 * 2 + 4 * 8 * (12 * 32 + 32 + 16) + 4 * 32)),  # 150 blocks of 4 > 132
        (3, 98, 4, 132, (4, 25, 3 * 16 * 116 * 4 + 4 * 8 * (12 * 16 + 16 + 8) + 4 * 16)),    # ragged H and B
        (208, 512, 2, 132, (4, 128, 3 * 16 * 512 * 2 + 4 * 208 * (12 * 16 + 16 + 8) + 4 * 16)),  # widest bf16 B
    ],
)
def test_lstm2_geometry_picks_fewest_units_with_one_block_per_sm(B, H, itemsize, sms, expected):
    assert lstm2_geometry(B, H, itemsize, sms) == expected
    jb, blocks, smem = expected
    assert smem == lstm2_smem_bytes(jb, B, H, itemsize) <= MAX_SMEM_BYTES
    assert jb % 4 == 0 and blocks * jb >= H and blocks <= sms


@pytest.mark.parametrize("B,H,itemsize", [(216, 512, 2), (160, 512, 4), (8, 1536, 2)])
def test_lstm2_geometry_raises_when_the_weights_cannot_stay_resident(B, H, itemsize):
    with pytest.raises(RuntimeError, match="shared memory"):
        lstm2_geometry(B, H, itemsize, 132)
