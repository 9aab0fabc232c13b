"""chip_smoke's HiFi-Codec serving rehearsals at a tiny width on the CPU.

The two longest rehearsals of the HiFi-Codec slice, in a file of their own
so that a run of the suite on several workers gives them a worker apart
from ``tests/test_torch_hificodec.py`` (whose ``TINY`` width they share).
"""

import torch

import chip_smoke
from tests.test_torch_hificodec import TINY
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_chip_smoke_fused_pre_and_extract_rehearsal():
    """chip_smoke's ``hifi_pre`` and ``extract`` phases at a tiny width on the
    CPU: launch counts of 0, the fused_pre decode equal to the unfused one,
    batched and one-file-a-call tokens equal."""
    tiny = dict(TINY, n_codes=64)
    r = chip_smoke.phase_hifi_pre(device="cpu", dtype=torch.float32, batch=2, seconds=0.2, iters=0, **tiny)
    assert not any(r["launches"].values()) and r["wav_rel_err_vs_unfused"] <= 1e-6
    assert r["distinct_tokens"] > 8
    r = chip_smoke.phase_extract(device="cpu", n_files=3, min_seconds=0.1, max_seconds=0.3, bucket_seconds=0.2,
                                 lm_width=dict(dim=16, num_heads=2, num_layers=1, past_context=8), **tiny)
    assert not any(r["launches"].values()) and r["token_mismatch"] == 0.0


def test_chip_smoke_extract_groupnorm_rehearsal():
    """chip_smoke's opt-in ``extract_groupnorm`` at a tiny width on the CPU: a
    warm-up and four corpus tokenizations, f32 and f64 statistics in turn,
    each token for token equal batched and one file a call, and
    ``GroupNormTorch.forward`` restored after it."""
    from academicodec_tpu_torch.nn.hifigan import GroupNormTorch

    forward = GroupNormTorch.forward
    tiny = dict(TINY, n_codes=64)
    r = chip_smoke.phase_extract_groupnorm("cpu", n_files=2, min_seconds=0.1, max_seconds=0.2, bucket_seconds=0.2,
                                           lm_width=dict(dim=16, num_heads=2, num_layers=1, past_context=8), **tiny)
    assert [run["stats"] for run in r["runs"]] == ["f32", "f64", "f64", "f32"]
    assert all(run["token_mismatch"] == 0.0 and run["audio_s_per_s"] is None for run in r["runs"])
    assert GroupNormTorch.forward is forward
