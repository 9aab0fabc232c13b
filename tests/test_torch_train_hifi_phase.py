"""``chip_smoke.phase_train_hifi`` rehearsed at a tiny width on the CPU.

No kernel launches there (the plain versions run); the phases' own checks
hold: finite losses, launch counts (0 on the CPU), the card-vs-CPU step and
its controls (the CPU against itself: the K3 fault must still fail the
check, by the D phase's wav, and so must a ``u`` stepped twice), the CLIs
end to end.
"""

import chip_smoke
from tests.test_torch_train_hifi import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), encoder_base_channels=8, n_codes=64)
DISCS = dict(stft_filters=4, stft_n_ffts=(256, 128), mpd_periods=(2, 3), msd_scales=2)


def test_recipe_is_the_reference_config():
    cfg, raw = chip_smoke.hifi_recipe()
    assert cfg.upsample_rates == (8, 5, 4, 2) and cfg.segment_size == 16000 and raw["batch_size"] == 80
    assert chip_smoke.fused_stage_counts(cfg) == {"resblock_tower": 2, "resblock_tower_gn": 1}


def test_chip_smoke_train_hifi_rehearsal():
    r = chip_smoke.phase_train_hifi("cpu", batch=1, samples=1600, steps=1, mp_steps=1, model=TINY, discs=DISCS,
                                    cross_batch=1, cross_samples=1600, cross_model=TINY, cross_discs=DISCS,
                                    cli_model=TINY, cli_files=2, cli_segment=2400)
    zero = {"resblock_tower": 0, "resblock_tower_gn": 0}
    assert r["f32"]["launches_step"] == r["f32"]["launches_eval"] == zero
    assert r["cross"]["codes_differ"] == 0 and r["cross"]["distinct_codes"] > chip_smoke.MIN_DISTINCT_TOKENS
    assert all(c["caught"] for c in r["cross"]["controls"].values())
    assert r["cross"]["controls"]["k3_off_1e-2"]["wav_rel_diff"]["no_grad"] > 1e-3
    assert r["cli"]["tokens_equal"] and r["cli"]["steps_after_resume"] == 3
