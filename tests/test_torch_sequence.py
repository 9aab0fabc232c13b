"""Time-sharded serving (``academicodec_tpu_torch/parallel/sequence.py``) on the CPU.

The port runs its shards on ``["cpu"] * 8`` beside the JAX package's
``TimeSharded*`` on the 8 virtual CPU devices of tests/conftest.py, at the
tiny configurations of tests/test_sharded_serving.py, with the JAX weights
carried across (``utils/convert``) and codebooks spread over the latent
frames so that tokens follow the wav. Contracts:

* port sharded against port unsharded: SoundStream codes identical and wav
  within atol 1e-6 / rtol 1e-6, the odd length 15993 included; VQVAE tokens
  identical and decode within 1e-6; compressor blobs byte-identical
  (tests/test_sharded_serving.py:116-135, 163-166, 198-204);
* port sharded against JAX sharded: tokens identical, wav within atol 1e-4 /
  rtol 1e-3 (the port's contract against JAX);
* the halo exchange gives each shard what the padded whole sequence holds,
  and K4's passes over time blocks (each block's own tiles) equal GroupNorm
  over the whole sequence.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import jax
import jax.numpy as jnp

from academicodec_tpu.codec.compress import SoundStreamCompressor as JCompressor
from academicodec_tpu.models.hificodec import VQVAE as JVQVAE
from academicodec_tpu.models.soundstream import SoundStream as JSoundStream
from academicodec_tpu.nn.hifigan import HiFiCodecConfig as JConfig
from academicodec_tpu.parallel import TimeShardedSoundStream as JTimeShardedSoundStream
from academicodec_tpu.parallel import TimeShardedVQVAE as JTimeShardedVQVAE
from academicodec_tpu.parallel import make_mesh
from academicodec_tpu.utils.torch_import import import_hificodec

from academicodec_tpu_torch.codec.compress import SoundStreamCompressor
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.hifigan import GroupNormTorch, HiFiCodecConfig, ResBlock1
from academicodec_tpu_torch.ops.cuda import resblock as rb_ops
from academicodec_tpu_torch.ops.padding import pad1d
from academicodec_tpu_torch.parallel import sequence
from academicodec_tpu_torch.utils.convert import soundstream_state_from_jax
from test_torch_soundstream import with_spread_codebooks
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)

SHARDS = ["cpu"] * 8
SS_KW = dict(n_filters=4, dimension=32, ratios=(8, 5, 4, 2), sample_rate=16000, target_bandwidths=(1, 2, 4), bins=64)
# tests/test_sharded_serving.py:145-149: encoder stages of 16, 32, 64 (K4) and 128 (unfused) channels,
# generator stages of 64, 32, 16 and 8 (K3, the last with conv_post)
VQ_KW = dict(upsample_rates=(5, 4, 2, 2), upsample_kernel_sizes=(11, 8, 4, 4), segment_size=4000,
             encoder_base_channels=8, upsample_initial_channel=128, n_codes=64)


def _wav(T, seed, batch=1):
    return (np.random.default_rng(seed).standard_normal((batch, T)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def soundstream():
    jmodel = JSoundStream(**SS_KW)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(jmodel.init, static_argnames=("training",))(
        {"params": rng, "rvq": rng}, jnp.zeros((1, 16000)), n_q=jmodel.n_q, training=False)
    variables = with_spread_codebooks(jmodel, variables, _wav(16000, 1, batch=2))
    model = SoundStream(**SS_KW, device="cpu")
    model.load_state_dict(soundstream_state_from_jax(variables))
    return jmodel, variables, model


@pytest.fixture(scope="module")
def vqvae():
    """A seeded port VQVAE with its codebooks spread over its latent frames, and
    the JAX copy imported from its reference ``g_*`` dict (a JAX init compiles
    for ~30 s)."""
    model = VQVAE(HiFiCodecConfig(**VQ_KW), device="cpu", seed=2)
    chip_smoke.spread_codebooks(model, chip_smoke.latent_frames(model, torch.from_numpy(_wav(16000, 3))), seed=2)
    return JVQVAE(config=JConfig(**VQ_KW)), import_hificodec(model.reference_state_dict()), model


def test_time_blocks():
    assert sequence.time_blocks(50, 8) == [(0, 7), (7, 14), (14, 20), (20, 26), (26, 32), (32, 38), (38, 44),
                                           (44, 50)]
    assert sequence.time_blocks(8, 8) == [(i, i + 1) for i in range(8)]
    assert sequence.time_blocks(7, 8) is None
    assert sequence.time_blocks(5, 1) == [(0, 5)]
    with pytest.raises(ValueError):
        sequence.time_blocks(5, 0)


@pytest.mark.parametrize("T,pads", [(23, (3, 5)), (3, (3, 4)), (2, (1, 3))])  # the last two: pad1d's guard
@pytest.mark.parametrize("mode", ["zero", "reflect"])
def test_halo_exchange_gives_the_padded_whole(T, pads, mode):
    """Every shard's range of the globally padded sequence, including ranges
    that reach over several shards and past both ends, equals the same slice
    of ``pad1d`` of the whole; the blocks sit on a repeated device list."""
    x = torch.from_numpy(_wav(T, 5, batch=6)).reshape(2, 3, T)
    ref = pad1d(x, pads, mode)
    spans = sequence.time_blocks(T, min(T, 4))
    xs = sequence.split_time(x, spans, ["cpu"] * len(spans))
    assert xs.spans == spans and xs.length == T and xs.shape == x.shape
    torch.testing.assert_close(xs.gather(), x, rtol=0, atol=0)
    for lo in range(-pads[0], T + pads[1]):
        for hi in range(lo, T + pads[1] + 1):
            got = sequence.halo_exchange(xs, [(lo, hi)] * len(spans), mode, pads)
            for g in got:
                torch.testing.assert_close(g, ref[..., lo + pads[0]:hi + pads[0]], rtol=0, atol=0)
    with pytest.raises(ValueError, match="outside the padded sequence"):
        sequence.halo_exchange(xs, [(-pads[0] - 1, 0)] * len(spans), mode, pads)


@pytest.mark.parametrize("T", [16000, 15993])
def test_soundstream_sharded_matches_unsharded_and_jax(soundstream, T):
    """8 shards, the last ragged at 15993 samples (extra right padding from
    the global length): codes identical, wav within 1e-6 of the unsharded
    port, and the JAX package's time-sharded serving's codes and wav."""
    jmodel, variables, model = soundstream
    wav = _wav(T, 7)
    ts = sequence.TimeShardedSoundStream(model, SHARDS, target_bw=4)
    codes, out = ts.roundtrip(torch.from_numpy(wav))
    assert len(codes.parts) == len(out.parts) == 8 and codes.shape == (8, 1, 50)
    ref = model.encode(torch.from_numpy(wav), target_bw=4)
    np.testing.assert_array_equal(np.asarray(codes), ref.numpy())
    np.testing.assert_allclose(np.asarray(out), model.decode(ref).numpy(), atol=1e-6, rtol=1e-6)
    assert len(np.unique(ref.numpy())) > 8
    jts = JTimeShardedSoundStream(jmodel, variables, make_mesh(), target_bw=4)
    jcodes, jout = jts.roundtrip(wav)
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(jcodes))
    np.testing.assert_allclose(np.asarray(out), np.asarray(jout), atol=1e-4, rtol=1e-3)


def test_soundstream_short_stream_is_served_unsharded(soundstream):
    """Fewer frames than shards: one block on the first device, the plain codes."""
    _, _, model = soundstream
    wav = torch.from_numpy(_wav(2000, 8))
    ts = sequence.TimeShardedSoundStream(model, SHARDS, target_bw=4)
    codes, out = ts.roundtrip(wav)
    assert len(codes.parts) == len(out.parts) == 1
    np.testing.assert_array_equal(np.asarray(codes), model.encode(wav, target_bw=4).numpy())
    assert ts.replicas == [model] * 8  # one model a distinct device, eight blocks on it
    with pytest.raises(ValueError, match="time_group_norm"):
        sequence.TimeShardedSoundStream(SoundStream(**SS_KW, norm="time_group_norm", device="cpu"), SHARDS)


@pytest.mark.parametrize("masked", [False, True])
def test_vqvae_sharded_matches_unsharded_and_jax(vqvae, masked):
    """Tokens of 8 shards identical to the unsharded port's and to the JAX
    package's time-sharded encode (masked: to its length-masked encode), the
    decode within 1e-6 of the unsharded port's and within the JAX contract of
    JAX's time-sharded decode."""
    jmodel, variables, model = vqvae
    T, valid = 16000, 13371
    wav = _wav(T, 9)
    if masked:
        wav[:, valid:] = 0.0
    lengths = torch.tensor([valid]) if masked else None
    ts = sequence.TimeShardedVQVAE(model, SHARDS)
    tokens = ts.encode(torch.from_numpy(wav), lengths)
    assert len(tokens.parts) == 8 and tokens.dim == 1
    ref = model.encode(torch.from_numpy(wav), lengths).numpy()
    np.testing.assert_array_equal(np.asarray(tokens), ref)
    assert len(np.unique(ref)) > 8
    if masked:
        jref = jax.jit(lambda v, w, n: jmodel.apply(v, w, lengths=n, method=JVQVAE.encode))(
            variables, jnp.asarray(wav), jnp.asarray([valid], jnp.int32))
        n = model.frames_for(valid)
        np.testing.assert_array_equal(np.asarray(tokens)[:, :n], np.asarray(jref)[:, :n])
        return
    jts = JTimeShardedVQVAE(jmodel, variables, make_mesh())
    np.testing.assert_array_equal(np.asarray(tokens), np.asarray(jts.encode(wav)))
    out = ts.decode(tokens)
    assert len(out.parts) == 8
    np.testing.assert_allclose(np.asarray(out), model.decode(torch.from_numpy(ref)).numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out), np.asarray(jts.decode(ref)), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("variant", ["wide_generator", "fused_pre", "causal"])
def test_vqvae_generator_variants_sharded_match_unsharded(variant):
    """The generator paths the tiny config does not take: a stage wider than
    64 channels (unfused, one halo for its resblocks), K3's convT prologue
    (the halo counted in input steps), and the causal generator (S-convs,
    twice the halo back); each at an odd frame count."""
    kw = dict(VQ_KW, upsample_initial_channel=256 if variant == "wide_generator" else 128,
              causal=variant == "causal")
    model = VQVAE(HiFiCodecConfig(**kw), device="cpu", seed=4)
    model.generator.fused_pre = variant == "fused_pre"
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (2, 77, 4)).astype(np.int32))
    out = sequence.TimeShardedVQVAE(model, SHARDS).decode(tokens)
    assert len(out.parts) == 8
    np.testing.assert_allclose(np.asarray(out), model.decode(tokens).numpy(), atol=1e-6, rtol=1e-6)


def test_compressor_time_sharded_blobs(soundstream):
    """``SoundStreamCompressor(devices=, shard_axis="time")`` on a length the
    8 shards split evenly and one they do not: blobs byte-identical to one
    device's and to the JAX compressor's on its 8-device mesh; decode within
    1e-6."""
    jmodel, variables, model = soundstream
    plain = SoundStreamCompressor(model, target_bw=4)
    sp = SoundStreamCompressor(model, target_bw=4, devices=SHARDS, shard_axis="time")
    jsp = JCompressor(jmodel, variables, target_bw=4, mesh=make_mesh(), shard_axis="time")
    for T in (16000, 9973):
        wav = _wav(T, 11)[0]
        blob = sp.compress(wav)
        assert blob == plain.compress(wav) == jsp.compress(wav)
        (a, sra), (b, srb) = sp.decompress(blob), plain.decompress(blob)
        assert sra == srb == 16000 and a.shape == b.shape == (T,)
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="shard_axis"):
        SoundStreamCompressor(model, devices=SHARDS, shard_axis="x")


@pytest.mark.parametrize("masked", [False, True])
def test_k4_shard_passes_are_groupnorm_over_the_whole(masked):
    """K4's passes over four time blocks, as ``_encoder_stage_gn_fused`` runs
    them, against the unfused chains (ResBlock1) and ``GroupNormTorch`` of the
    whole sequence: the blocks' owned tiles cover the sequence's tiles once, in
    order (one block lies inside a tile and owns none); each block's partials
    of its tiles, from pass 1 on its window alone, are the whole chains'
    per-tile moments; reduced, they are the whole chains' moments; the affines
    from them and the global count, applied to each block's own frames, give
    the whole GroupNorm chain. Masked: the last block ends past the valid
    frames, which count alone."""
    torch.manual_seed(0)
    C, ks, dss, B, N = 16, (3, 7), ((1, 3, 5), (1, 3, 5)), 2, 3001
    spans = [(0, 1000), (1000, 1500), (1500, 2400), (2400, N)]
    blocks = [ResBlock1(C, k, ds, norm="none") for k, ds in zip(ks, dss)]
    norms = [GroupNormTorch(1, C) for _ in ks]
    for m in blocks + norms:
        for p in m.parameters():
            p.data = torch.randn(p.shape) * (0.3 if p.dim() > 1 else 0.5) + (1.0 if p.dim() == 1 else 0.0)
    x = torch.randn(B, C, N)
    L = torch.tensor([N, 2222]) if masked else None
    ws, bs = zip(*(rb.weights_and_biases() for rb in blocks))
    packed = rb_ops.pack_tower(ws, bs, kernel_sizes=ks, dilation_sizes=dss)
    TT = rb_ops.gn_tile(packed)
    ranges, tiles = sequence.k4_shard_tiles(spans, N, rb_ops.tower_halo(ks, dss), TT)
    assert [t for a, b in tiles for t in range(a, b)] == list(range(-(-N // TT))) and tiles[1][0] == tiles[1][1]
    with torch.no_grad():
        mask = None if L is None else rb_ops.frame_mask(L, N).to(x.dtype)
        rs = [rb(x * (1 if mask is None else mask), mask) for rb in blocks]
        xs = None
        for r, gn in zip(rs, norms):
            xs = gn(r if xs is None else xs + r, mask, L)
            xs = xs if mask is None else xs * mask
        ref = xs / len(ks)
        whole_tiles = rb_ops.tile_moments_plain(rs, TT)
        scales, biases = torch.stack([n.weight for n in norms]), torch.stack([n.bias for n in norms])
        outs, parts = [], []
        for (lo, hi), (t_lo, t_hi), (a, b) in zip(ranges, tiles, spans):
            assert lo % TT == 0 and lo <= a and b <= hi
            r, part = rb_ops.gn_tower_partials(x[..., lo:hi].contiguous(), packed, None if L is None else L - lo)
            torch.testing.assert_close(r[..., a - lo:b - lo], torch.stack(rs)[..., a:b], rtol=1e-5, atol=1e-5)
            outs.append(r[..., a - lo:b - lo])
            parts.append(part[:, t_lo - lo // TT:t_hi - lo // TT])
        part = torch.cat(parts, dim=1)
        torch.testing.assert_close(part, whole_tiles, rtol=1e-5, atol=1e-4)
        mom = rb_ops.moments_reduce(part)
        torch.testing.assert_close(mom, rb_ops.moments(rs), rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(mom, rb_ops.moments_reduce_plain(whole_tiles), rtol=1e-5, atol=1e-4)
        A, K = rb_ops.gn_tower_affines(mom, scales, biases, 1, 1e-6, N, L)
        for r, (a, b) in zip(outs, spans):
            y = rb_ops.gn_tower_apply(r, A, K, None if L is None else L - a)
            torch.testing.assert_close(y, ref[..., a:b], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,unit", [(16000, 160), (15993, 160), (1000, 8)])
def test_sharded_k4_stage_tiles_the_whole_sequence(vqvae, T, unit):
    """The encoder's K4 stage over 8 shards of whole ``unit``-frame blocks: every
    tile of one call over the whole sequence is summed by exactly one shard, in
    the sequence's tile order (the card's bits of one launch; here the plain
    sums), and the stage's output is that call's within 1e-5. At T 1000 the
    blocks are shorter than a tile, and all but the first own none."""
    _, _, model = vqvae
    enc = model.encoder
    with torch.no_grad():
        x = enc.ups[0](torch.nn.functional.leaky_relu(enc.conv_pre(torch.from_numpy(_wav(T, 13))[:, None]), 0.1))
        norms = enc.stage(0)[1]
        packed = enc.packed_tower(0)
        ref = rb_ops.resblock_tower_gn(x, packed, None, torch.stack([n.weight for n in norms]),
                                       torch.stack([n.bias for n in norms]), num_groups=x.shape[1] // 16)
        spans = [(a * unit, min(b * unit, x.shape[2])) for a, b in sequence.time_blocks(-(-x.shape[2] // unit), 8)]
        assert (x.shape[2] < rb_ops.gn_tile(packed)) == (T == 1000)
        got = sequence._encoder_stage_gn_fused([enc] * 8, 0, sequence.split_time(x, spans, SHARDS), None)
    assert len(got.parts) == 8
    torch.testing.assert_close(got.gather(), ref, rtol=1e-5, atol=1e-5)


def test_chip_smoke_sequence_rehearsal():
    """``chip_smoke.phase_sequence`` on the CPU at a tiny width: every run held
    at its limits, the compressor's blobs byte-identical, the short file served
    unsharded."""
    r = chip_smoke.phase_sequence("cpu", seconds=1.0, shards=4, iters=1, hifi_seconds=1.0, bucket_seconds=0.3,
                                  compress_seconds=(1.0, 0.77), encodec=dict(n_filters=4, dimension=32, bins=64),
                                  hifi=chip_smoke.HIFI_CROSS_MODEL, hifi_bf16=False)
    assert r["compress"]["blobs_identical"] == [True] * 3
    assert r["encodec_f32"]["4 shards"]["tokens_differ"] == 0 and r["extract"]["exact"]["tokens_differ"] == 0
