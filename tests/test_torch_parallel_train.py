"""Both GAN trainers' data-parallel steps on the CPU: two gloo ranks against one.

``chip_smoke._parallel_ranks`` (the card's phase ``parallel`` (b)) at the
tiny widths of tests/test_torch_train.py and tests/test_torch_train_hifi.py:
two worker processes, started with the environment torchrun gives a rank,
run each case on their rank-major halves of one global batch, and this
process runs it on the whole batch. JAX's contract
(tests/test_train.py:253-296, ``chip_smoke.DP_LIMITS``): losses rtol 1e-4,
codebooks and parameters atol 1e-5 + rtol 1e-4, codes equal; the ranks'
parameters, buffers (codebooks, the spectral norm's ``u``) and Adam moments
bitwise equal. The Encodec cases are ``accum_steps`` 1 and 2: the k-means
init step, two steps from an inited state at the trainer's learning rate,
and at ``accum_steps`` 2 one step at learning rate 0
(``chip_smoke.parallel_cases_ranks``). The HiFi-Codec case runs two steps at
``accum_steps`` 2. Every case holds everything (``DP_HELD_ALL``): the losses,
every step's gradients, the parameters, every search's codes and the
codebooks. The 1-rank run evaluates the encoder in the ranks' row blocks
(``chip_smoke.dp_run``), so its latents are the ranks' bit for bit: no code
parts, and no codebook entry is left out of the limit.

Three fault controls must fail the comparison: the codebooks' EMA sums left
on each rank (``no_ema``, a plain DDP wrap's per-rank EMA), the feature
loss's ``mean|r|`` over each rank's rows (``local_norm``) and each rank's
microbatches taken from its own rows in their order (``local_split``).

The Encodec codebooks have 16 entries, so that a microbatch holds several
frames an entry (chip_smoke.parallel_cases_ranks), and the feature loss
counts from the first step.
"""

import pytest

import chip_smoke
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from tests.test_torch_train import TINY, one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_train_hifi import TINY_DISCS, TINY_MODEL

ENCODEC = dict(TINY, bins=16, target_bandwidths=(1, 2), discriminator_iter_start=0)
FAULTS = ("no_ema", "local_norm", "local_split")
CASES = ("encodec_init_k1", "encodec_k1", "encodec_init_k2", "encodec_k2", "encodec_k2_lr0", "hifi_k2")


@pytest.fixture(scope="module")
def compared(tmp_path_factory):
    cases = chip_smoke.parallel_cases_ranks(
        "cpu", encodec=ENCODEC, enc_batch=8, enc_seconds=0.4, hifi_model=HiFiCodecConfig(**TINY_MODEL),
        hifi_discs=TINY_DISCS, hifi_batch=4, hifi_samples=512, accum=(1, 2), faults=FAULTS,
        held=chip_smoke.DP_HELD_ALL)
    assert set(cases) == set(CASES) | {f"encodec_{f}" for f in FAULTS}
    return cases, chip_smoke._parallel_ranks("cpu", cases, workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_make_the_one_rank_step(compared, name):
    cases, out = compared
    assert out[name]["failures"] == []
    assert out[name]["loss_rel"] <= chip_smoke.DP_LIMITS["loss_rtol"]
    assert out[name]["moved_entries"] == 0 and out[name]["near_ties"] == 0  # no code parts here


def test_the_comparison_covers_the_state(compared):
    """What the ranks are held equal in: every parameter, the codebooks' EMA
    state, the spectral norm's ``u`` and both optimizers' moments."""
    cases = compared[0]
    keys = set()
    for name in ("hifi_k2", "encodec_k2"):  # the second starts after a step: its optimizers have moments
        state = chip_smoke.dp_trainer(cases[name]["family"], cases[name]["cfg"], "cpu").init_state(0)
        state.load_state_dict(cases[name]["start"])
        keys |= set(chip_smoke.dp_state_tensors(state))
    assert any(k.startswith("d.buffer.") and k.endswith("weight_u") for k in keys)
    assert {"g.buffer.quantizer.vq.embed", "g.buffer.quantizer.vq.embed_avg",
            "g.buffer.quantizer.vq.cluster_size"} <= keys
    for tag in ("g", "d"):
        assert any(k.startswith(f"{tag}.exp_avg.") for k in keys) and any(k.startswith(f"{tag}.exp_avg_sq.")
                                                                           for k in keys)


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_control_fails_the_comparison(compared, fault):
    assert compared[1][f"encodec_{fault}"]["failures"]


def test_a_failing_rank_fails_the_launch(compared, tmp_path):
    """A rank that raises fails ``dp_launch`` with its log, and no process is left."""
    bad = {"bad": dict(compared[0]["encodec_k2"], fault="no_such_fault")}
    with pytest.raises(AssertionError, match="exited 1"):
        chip_smoke.dp_launch(bad, "cpu", 2, str(tmp_path), timeout=120)
