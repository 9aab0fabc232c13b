"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run (set-up, the window, the check) on the
CPU at tiny widths, skipping only the command's look for a card, with the
entry's call broken in one way that the roundtrip and tokenization cells
can have: half of the batch left out (its rows answered with the other
half's), a token altered where it is produced, a decoded sample altered,
the bias in front of the decoded wav dropped.
"""

import pytest
import torch

from portbench import harness
from portbench.entries import codec
from portbench.faults import half_batch, post_bias_dropped, sample_altered, token_altered
from portbench.tests.common import ENCODEC, HIFI, TINY, TOKENIZE, one_thread  # noqa: F401


@pytest.mark.parametrize("workload,fault", [
    (ENCODEC, half_batch), (ENCODEC, token_altered), (ENCODEC, sample_altered), (ENCODEC, post_bias_dropped),
    (HIFI, half_batch), (HIFI, token_altered), (HIFI, sample_altered), (HIFI, post_bias_dropped),
    (TOKENIZE, half_batch), (TOKENIZE, token_altered),
])
def test_a_broken_call_is_not_correct(workload, fault, monkeypatch, one_thread):
    sound = harness.run(workload, 21, 0.05, False, "cpu", overrides=TINY[workload])
    assert sound["correct"], sound["checks"]
    call = codec.call
    monkeypatch.setattr(codec, "call", lambda ctx, i: fault(ctx, call(ctx, i)))
    broken = harness.run(workload, 21, 0.05, False, "cpu", overrides=TINY[workload])
    assert broken["correct"] is False, broken["checks"]


def test_a_failing_call_is_counted_and_not_correct(monkeypatch, one_thread):
    call = codec.call

    def flaky(ctx, i):
        if i == ctx.traffic["batches"] + 1:  # one call inside the window
            raise RuntimeError("device lost")
        return call(ctx, i)

    monkeypatch.setattr(codec, "call", flaky)
    r = harness.run(ENCODEC, 21, 0.2, False, "cpu", overrides=TINY[ENCODEC])
    assert r["failed"] == 1 and r["attempted"] >= 2 and r["correct"] is False
    assert torch.is_grad_enabled()
