"""The port's RVQ (plain K1, ResidualVQ, bandwidth selection) against the JAX package.

Tokens must be exactly equal; the Pallas kernel runs interpreted, as the
JAX package's own tests run it on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from academicodec_tpu.models.soundstream import SoundStream as JSoundStream
from academicodec_tpu.ops.pallas.rvq import rvq_encode_fused
from academicodec_tpu.quant.core_vq import ResidualVQ as JResidualVQ
from academicodec_tpu.quant.core_vq import l2_distance_argmin as j_l2_distance_argmin

from academicodec_tpu_torch.ops.cuda.rvq import rvq_encode, rvq_encode_plain
from academicodec_tpu_torch.quant.core_vq import ResidualVQ, l2_distance_argmin
from academicodec_tpu_torch.quant.vq import ResidualVectorQuantizer


def _codebook_state(embed):
    return {
        "embed": jnp.asarray(embed),
        "embed_avg": jnp.asarray(embed),
        "cluster_size": jnp.ones(embed.shape[:2], jnp.float32),
        "inited": jnp.ones(embed.shape[:1], bool),
    }


@pytest.mark.parametrize("n,d,k,n_q,tile", [(75, 32, 64, 2, 32), (200, 64, 128, 4, 128), (300, 48, 100, 3, 256)])
def test_plain_equals_interpreted_pallas_kernel(n, d, k, n_q, tile):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    embed = rng.standard_normal((n_q, k, d)).astype(np.float32)
    ref = np.asarray(rvq_encode_fused(jnp.asarray(x), jnp.asarray(embed), tile=tile, interpret=True))
    codes = rvq_encode_plain(torch.from_numpy(x), torch.from_numpy(embed))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), ref)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(rvq_encode(torch.from_numpy(x), torch.from_numpy(embed)).numpy(), ref)


def test_l2_distance_argmin_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    e = rng.standard_normal((256, 16)).astype(np.float32)
    e[7] = e[3]  # an exact tie: the lower index wins on both sides
    x[:5] = e[3]
    ref = np.asarray(j_l2_distance_argmin(jnp.asarray(x), jnp.asarray(e)))
    np.testing.assert_array_equal(l2_distance_argmin(torch.from_numpy(x), torch.from_numpy(e)).numpy(), ref)


@pytest.mark.parametrize("n_q,st", [(None, 0), (6, 0), (6, 2), (8, 5)])
def test_residual_vq_encode_decode_match_jax(n_q, st):
    layers, bins, dim = 8, 64, 16
    rng = np.random.default_rng(st)
    embed = rng.standard_normal((layers, bins, dim)).astype(np.float32)
    x = rng.standard_normal((2, 37, dim)).astype(np.float32)
    jmod = JResidualVQ(num_quantizers=layers, dim=dim, codebook_size=bins)
    state = {"codebook": _codebook_state(embed)}
    ref_codes = np.asarray(jmod.apply(state, jnp.asarray(x), n_q=n_q, st=st, method=JResidualVQ.encode))

    mod = ResidualVQ(layers, dim, bins)
    mod.embed.copy_(torch.from_numpy(embed))
    codes = mod.encode(torch.from_numpy(x), n_q=n_q, st=st)
    np.testing.assert_array_equal(codes.numpy(), ref_codes)

    ref_q = np.asarray(jmod.apply(state, jnp.asarray(ref_codes), st=st, method=JResidualVQ.decode))
    np.testing.assert_allclose(mod.decode(codes, st=st).numpy(), ref_q, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bw", [None, 0.0, 0.5, 1.5, 2, 3.9, 6, 12, 24, 100])
def test_bandwidth_to_n_q_clamp_matches_jax(bw):
    jmodel = JSoundStream(n_filters=4, dimension=32, ratios=(8, 5, 4, 2), sample_rate=16000,
                          target_bandwidths=(1, 1.5, 2, 4, 6, 12), bins=256)
    q = ResidualVectorQuantizer(dimension=32, n_q=jmodel.n_q, bins=256)
    assert q.get_num_quantizers_for_bandwidth(jmodel.frame_rate, bw) == jmodel.n_q_for_bandwidth(bw)


def test_state_dict_uses_reference_keys_and_folds_layers():
    mod = ResidualVQ(3, 4, 8)
    embed = torch.randn(3, 8, 4, generator=torch.Generator().manual_seed(0))
    sd = {f"layers.{i}._codebook.{name}": value
          for i in range(3)
          for name, value in (("embed", embed[i]), ("embed_avg", embed[i]),
                              ("cluster_size", torch.ones(8)), ("inited", torch.ones(1)))}
    mod.load_state_dict(sd)  # strict: the EMA statistics are accepted
    assert torch.equal(mod.embed, embed)
    assert sorted(mod.state_dict()) == [f"layers.{i}._codebook.embed" for i in range(3)]
    with pytest.raises(RuntimeError, match="Unexpected"):
        mod.load_state_dict({**sd, "layers.3._codebook.embed": embed[0]})
    with pytest.raises(RuntimeError, match="Missing"):
        mod.load_state_dict({k: v for k, v in sd.items() if not k.startswith("layers.1.")})
