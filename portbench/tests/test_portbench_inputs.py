"""Traffic and weights are made from the seed, and only from it."""

import pytest
import torch

from portbench import inputs
from portbench.families import hificodec, soundstream

TRAFFIC = dict(batch=5, clip_seconds=[0.2, 0.5], bucket_seconds=0.5, batches=3)


def test_batches_repeat_for_a_seed_and_change_with_it():
    a = inputs.seeded_batches(TRAFFIC, 400, 3000000001, "cpu")
    b = inputs.seeded_batches(TRAFFIC, 400, 3000000001, "cpu")
    c = inputs.seeded_batches(TRAFFIC, 400, 3000000002, "cpu")
    for (wa, la), (wb, lb) in zip(a, b):
        assert torch.equal(wa, wb) and torch.equal(la, lb)
    assert not torch.equal(a[0][0], c[0][0])


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40])
def test_every_seed_sends_the_same_work(seed):
    """Each batch holds the same clip lengths in another order, zero past each clip."""
    expected = sorted(inputs.clip_lengths(TRAFFIC, 400))
    for wav, lengths in inputs.seeded_batches(TRAFFIC, 400, seed, "cpu"):
        assert sorted(lengths.tolist()) == expected
        assert wav.shape == (5, 200)
        for row, n in zip(wav, lengths.tolist()):
            assert torch.all(row[n:] == 0) and torch.count_nonzero(row[:n]) == n


def test_clip_lengths_spread_evenly():
    assert inputs.clip_lengths(dict(batch=4, clip_seconds=[3.0, 10.0]), 24000) == [93000, 135000, 177000, 219000]
    assert inputs.clip_lengths(dict(batch=2, clip_seconds=[10.0, 10.0]), 24000) == [240000, 240000]
    with pytest.raises(ValueError):
        inputs.seeded_batches(dict(TRAFFIC, bucket_seconds=0.3), 400, 1, "cpu")


@pytest.mark.parametrize("family,cfg", [
    (soundstream, dict(n_filters=4, dimension=32, bins=64, ratios=[2, 2], sample_rate=400,
                       target_bandwidths=[1, 12])),
    (hificodec, dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], upsample_initial_channel=32,
                     encoder_base_channels=8, resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
                     n_codes=64, n_code_groups=2)),
])
def test_weights_repeat_for_a_seed(family, cfg):
    specs = family.specs(cfg)
    a, b = inputs.seeded_state_dict(specs, 7, "cpu"), inputs.seeded_state_dict(specs, 7, "cpu")
    c = inputs.seeded_state_dict(specs, 8, "cpu")
    assert list(a) == list(specs)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if specs[k][1] == "uniform")
    for name, (shape, kind, fan_in) in specs.items():
        assert tuple(a[name].shape) == tuple(shape)
        if kind == "uniform":
            assert a[name].abs().max() <= fan_in ** -0.5
        if kind == "norm_of_v":  # the resolved weight g v / |v| is v itself
            v = a[name[: -len("weight_g")] + "weight_v"]
            assert torch.allclose(a[name] * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt(), v)


def test_spread_codebooks_follow_the_frames():
    frames = torch.randn(300, 8, generator=torch.Generator().manual_seed(0))
    books = inputs.spread_codebooks(frames, 3, 2, 16, seed=5)
    assert books.shape == (3, 2, 16, 4)
    assert torch.equal(books, inputs.spread_codebooks(frames, 3, 2, 16, seed=5))
    # layer 0 sits near latent frames: each entry within noise of some frame
    d = torch.cdist(books[0].transpose(0, 1).reshape(16, 8), frames).min(dim=1).values
    assert d.max() < 0.1 * frames.std() * 8
