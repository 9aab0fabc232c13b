"""Each cell's control comes out not correct: the reference in the program's place,
computed in the precision below the cell's (fp8 below bf16, TF32 below f32),
judged as a run judges the program, fails at least one of the cell's limits.

At tiny widths on the CPU; PERF.md gives the control's readings at the
cell's own size on the card (``portbench/control.py``)."""

import pytest
import torch

from portbench import control, harness
from portbench.tests.common import ENCODEC, HIFI, TINY, TOKENIZE, one_thread  # noqa: F401

CONTROL = {ENCODEC: "fp8", HIFI: "fp8", TOKENIZE: "tf32"}


@pytest.mark.parametrize("workload", [ENCODEC, HIFI, TOKENIZE])
def test_the_control_is_not_correct(workload, one_thread):
    readings = list(control.readings(workload, [3], [CONTROL[workload]], [3], 1, "cpu", overrides=TINY[workload]))
    program = next(r for r in readings if r["side"] == "program")
    ctl = next(r for r in readings if r["side"] != "program")
    limits = harness.make_context(workload, 3, "cpu").limits
    assert limits
    assert all(program[k] <= v for k, v in limits.items()), (program, limits)
    assert any(ctl[k] > v for k, v in limits.items()), (ctl, limits)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -12])
    assert control.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]
