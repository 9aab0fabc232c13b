"""The HiFi-Codec encoder's segmented wide stages (``nn/hifigan.Segments``), on the CPU.

Given host lengths, the length-masked encode runs each stage wider than K4's
on its rows' valid frames laid end to end in one row, each followed by a gap
of zeros as wide as the stage's convs reach. Held here against the padded
masked path (the same call with lengths it cannot read on the host:
``on_host`` patched to False, as device lengths are) and against each row's
exact-length encode: tokens equal, the encoder's output within f32 rounding
on the valid frames. In bf16 the output is held within 2% of its peak (a few
bf16 ulps: against the padded path it reads 0.4-0.9%, and the padded path
reads 0.8-1.3% against the exact-length encodes), and the tokens are not held
(a bf16 ulp moves this tiny model's tokens by ~10% of a row, the padded
path's against the exact-length encodes as much). The counters ``encoder.frames`` / ``encoder.frames_computed`` are
read for given lengths, the tokenization cell's included (on the meta
device: shapes only), and the paths that must not segment are held to the
padded path's op sequence by a gather that raises.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.presets import HIFICODEC_PRESETS
from academicodec_tpu_torch.nn import hifigan
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig, HiFiGANEncoder, Padded, Segments, frame_mask, stage_reach
from academicodec_tpu_torch.utils import profiling

# encoder stages of 32 and 64 channels (K4's plain version) and of 128 and 256
# (segmented); hop 32, the bucket 100 frames
BASE = dict(upsample_rates=(2, 2, 4, 2), upsample_kernel_sizes=(4, 4, 8, 4), upsample_initial_channel=128,
            encoder_base_channels=16, n_codes=64)
CONFIGS = {
    "resblock1": dict(BASE),  # k 3/7/11, dilations 1/3/5: reach 25
    "resblock2": dict(BASE, resblock="2", resblock_dilation_sizes=((1, 3), (1, 3), (1, 3))),  # reach 15
}
BUCKET = 3200


def _single_frame(model) -> int:
    """The fewest samples that give one frame at the last stage."""
    return next(n for n in range(1, BUCKET) if model.frames_for(n) == 1)


PATTERNS = {
    # the tokenization cell's: evenly spaced from 3 to 10 s of a 10 s bucket
    "evenly_spaced": lambda m: [round((0.3 + 0.7 * (i + 0.5) / 6) * BUCKET) for i in range(6)],
    "one_short_row": lambda m: [BUCKET, BUCKET, 1000, BUCKET],
    "row_shorter_than_reach": lambda m: [BUCKET, 600, 2400],  # 18 last-stage frames against a reach of 25 / 15
    "single_last_stage_frame": lambda m: [BUCKET, _single_frame(m), 2000],
    "all_full": lambda m: [BUCKET] * 3,  # no stage segments
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_MODELS = {}


def _model(config: str, dtype: torch.dtype):
    """The tiny model, its codebooks spread over the latent frames of the
    evenly spaced batch (so that tokens follow the latents)."""
    key = (config, dtype)
    if key not in _MODELS:
        model = VQVAE(HiFiCodecConfig(**CONFIGS[config]), device="cpu", dtype=dtype)
        wavs = _wavs(PATTERNS["evenly_spaced"](model))
        chip_smoke.spread_codebooks(model, chip_smoke.latent_frames(model, torch.from_numpy(np.concatenate(wavs))[None]))
        _MODELS[key] = model
    return _MODELS[key]


def _wavs(lengths, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def _batch(wavs) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.pad(w, (0, BUCKET - len(w))) for w in wavs]))


def _padded_path(monkeypatch):
    """Lengths the encoder cannot read on the host: the padded masked path."""
    monkeypatch.setattr(hifigan, "on_host", lambda lengths: False)


def _counts(run):
    profiling.reset("encoder.frames", "encoder.frames_computed")
    out = run()
    return out, profiling.total("encoder.frames").count, profiling.total("encoder.frames_computed").count


def _expected_counts(model, lengths, T=BUCKET):
    """``(encoder.frames, encoder.frames_computed)`` of one call, from the shapes."""
    enc = model.encoder
    gap = stage_reach(enc.rks, enc.rds)
    L = list(lengths)
    padded = computed = 0
    for i, (u, k) in enumerate(enc.ups_cfg):
        L = [hifigan.strided_length(n, k, u) for n in L]
        T = hifigan.strided_length(T, k, u)
        if enc.fused_stage(i):
            continue
        seg = sum(n + gap for n in L)
        padded += len(L) * T
        computed += seg if seg < len(L) * T else len(L) * T
    return padded, computed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_segmented_encode_matches_the_padded_path_and_exact_lengths(monkeypatch, pattern, config, dtype):
    """In f32, tokens of the segmented encode equal the padded masked path's
    and each row's exact-length encode; the encoder's output agrees with the
    padded path's on every valid frame within the dtype's rounding; the
    counters read what the shapes give; the last stage's output is zero past
    each row's frames."""
    model = _model(config, dtype)
    lengths = PATTERNS[pattern](model)
    wavs = _wavs(lengths)
    batch, L = _batch(wavs), torch.tensor(lengths)
    posts = []
    hook = model.encoder.conv_post.register_forward_pre_hook(lambda mod, args: posts.append(args[0]))
    with torch.no_grad():
        seg_out, frames, computed = _counts(lambda: model.encoder(batch[:, None].to(dtype), L))
        codes = model.encode(batch, lengths=L)
    hook.remove()
    assert (frames, computed) == _expected_counts(model, lengths)
    assert (computed == frames) == (pattern == "all_full")
    with monkeypatch.context() as mp:
        _padded_path(mp)
        with torch.no_grad():
            pad_out, pad_frames, pad_computed = _counts(lambda: model.encoder(batch[:, None].to(dtype), L))
            pad_codes = model.encode(batch, lengths=L)
    assert pad_frames == pad_computed == frames
    tol = dict(rtol=0, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=0.02)
    scale = pad_out.float().abs().max().item()
    for b, n in enumerate(lengths):
        f = model.frames_for(n)
        torch.testing.assert_close(seg_out[b, :, :f].float() / scale, pad_out[b, :, :f].float() / scale, **tol)
        assert not posts[0][b, :, f:].any()  # zeros past the lengths before conv_post
    assert len(np.unique(codes.numpy())) > 8
    if dtype == torch.float32:
        assert torch.equal(codes, pad_codes)
        for b, w in enumerate(wavs):
            alone = model.encode(torch.from_numpy(w)[None])
            assert alone.shape[1] == model.frames_for(len(w))
            assert torch.equal(codes[b, :alone.shape[1]], alone[0])


def test_segments_lay_out_and_sum_each_row():
    """The layout itself: each row's valid frames at its offset, gaps of zeros,
    the padded batch back; per-segment sums over valid frames only; a row of
    no frames and rows past the batch's width (clamped) included."""
    B, C, T, gap = 4, 3, 9, 2
    lengths = [9, 0, 4, 12]
    x = torch.randn(B, C, T) * frame_mask(torch.tensor(lengths).clamp(max=T), T)
    seg = Segments(lengths, torch.tensor(lengths), gap, T)
    assert seg.N == 9 + 0 + 4 + 9 + 4 * gap and seg.offsets == [0, 11, 13, 19]
    row = seg.gather(x)
    assert row.shape == (1, C, seg.N)
    for b, (o, n) in enumerate(zip(seg.offsets, seg.lengths)):
        assert torch.equal(row[0, :, o:o + n], x[b, :, :n])
        assert not row[0, :, o + n:o + n + gap].any()
    assert torch.equal(seg.valid[0, 0].float(), (row != 0).any(1)[0].float())
    assert torch.equal(seg.scatter(row), x)
    v = torch.arange(2 * seg.N, dtype=torch.float64).reshape(2, seg.N) + 1
    want = torch.stack([torch.stack([v[g, o:o + n].sum() for o, n in zip(seg.offsets, seg.lengths)]) for g in range(2)])
    assert torch.equal(seg.sums(v), want)
    assert torch.equal(seg.spread(want, None)[:, 0, seg.offsets[2]], want[:, 2])


def test_segmented_groupnorm_equals_the_masked_groupnorm_per_row():
    """``GroupNormTorch`` over the segmented row against its masked forward over
    the padded batch: the valid frames agree to f32 rounding (the same
    statistics summed in another order)."""
    gn = hifigan.GroupNormTorch(4, 64)
    with torch.no_grad():
        gn.weight.normal_(1.0, 0.1)
        gn.bias.normal_(0.0, 0.1)
    lengths, T = [50, 7, 33], 50
    L = torch.tensor(lengths)
    mask = frame_mask(L, T).float()
    x = (torch.randn(3, 64, T) + 0.3) * mask
    seg = Segments(lengths, L, 5, T)
    with torch.no_grad():
        padded = gn(x, Padded(L, None, x)) * mask
        row = gn(seg.gather(x), seg) * seg.valid.float()
    torch.testing.assert_close(seg.scatter(row), padded, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_time_blocks_groupnorm_equals_the_padded_groupnorm(masked):
    """``GroupNormTorch`` over a padded batch cut into time blocks
    (``parallel/sequence.TimeBlocks``: each block's own frames, their sums
    added on the first block's device, the global count) against the padded
    layout over the whole batch, in f32: every frame (unmasked) or the valid
    frames (masked) agree to f32 rounding (the same statistics summed in
    another order)."""
    from academicodec_tpu_torch.parallel.sequence import TimeBlocks, split_time

    gn = hifigan.GroupNormTorch(4, 64)
    with torch.no_grad():
        gn.weight.normal_(1.0, 0.1)
        gn.bias.normal_(0.0, 0.1)
    T = 50
    L = torch.tensor([50, 7, 33]) if masked else None
    frames = Padded(L, None, torch.empty(3, 64, T)) if masked else Padded()
    x = frames.masked(torch.randn(3, 64, T) + 0.3)
    blocks = split_time(x, [(0, 12), (12, 13), (13, 40), (40, T)], ["cpu"] * 4)
    with torch.no_grad():
        padded = frames.masked(gn(x, frames))
        sharded = TimeBlocks(blocks, L)
        out = sharded.masked(gn(blocks, sharded))
    assert [p.shape[2] for p in out.parts] == [12, 1, 27, 10]
    torch.testing.assert_close(out.gather(), padded, rtol=1e-5, atol=1e-6)


def test_the_tokenization_cells_counters():
    """The cell's 16 rows of 3-10 s in a 10 s bucket at the published widths
    (on the meta device: shapes, no data): 383,400 of 588,000 frames, 0.652."""
    with torch.device("meta"):
        enc = HiFiGANEncoder(HiFiCodecConfig(**HIFICODEC_PRESETS["hificodec_24k_320d"]))
    lengths = [round((3.0 + 7.0 * (i + 0.5) / 16) * 24000) for i in range(16)]
    Lh, T = torch.tensor(lengths), 240000
    profiling.reset("encoder.frames", "encoder.frames_computed")
    with torch.no_grad():
        for i, (u, k) in enumerate(enc.ups_cfg):
            Lh, T = hifigan.strided_length(Lh, k, u), hifigan.strided_length(T, k, u)
            if not enc.fused_stage(i):
                L = Lh.to("meta")
                x = torch.empty(16, enc.config.encoder_base_channels * 2 ** (i + 1), T, device="meta")
                assert enc.stage_forward(i, x, hifigan.Padded(L, Lh, x)).shape == x.shape
    frames, computed = profiling.total("encoder.frames").count, profiling.total("encoder.frames_computed").count
    assert stage_reach(enc.rks, enc.rds) == 25
    want, L = 0, torch.tensor(lengths)
    for u, k in enc.ups_cfg:
        L = hifigan.strided_length(L, k, u)
        want += int(L.sum()) + 16 * 25
    want -= int(hifigan.strided_length(torch.tensor(lengths), 4, 2).sum()) + 16 * 25  # stage 0 is K4's
    assert (frames, computed) == (16 * (30000 + 6000 + 750), want)
    assert round(computed / frames, 3) == 0.652


@pytest.mark.parametrize("call", ["no_lengths", "device_lengths", "grad_enabled"])
def test_the_paths_that_do_not_segment(monkeypatch, call):
    """No lengths, lengths not on the host, and a call autograd records run the
    padded path: the gather is never called, and the counters read equal."""
    model = _model("resblock1", torch.float32)
    lengths = PATTERNS["evenly_spaced"](model)
    batch, L = _batch(_wavs(lengths))[:, None], torch.tensor(lengths)

    def refuse(*args):
        raise AssertionError("segmented")

    monkeypatch.setattr(Segments, "gather", refuse)
    with monkeypatch.context() as mp:
        if call == "device_lengths":
            _padded_path(mp)
        with torch.set_grad_enabled(call == "grad_enabled"):
            _, frames, computed = _counts(lambda: model.encoder(batch, None if call == "no_lengths" else L))
    assert frames == computed == _expected_counts(model, [BUCKET] * len(lengths))[0]
    with pytest.raises(AssertionError, match="segmented"), torch.no_grad():
        model.encoder(batch, L)
