"""The plain reference agrees with the port on the CPU at tiny widths, and the checks see faults.

The test imports both; ``portbench/reference/`` itself imports torch alone
(``test_portbench_imports.py``)."""

import pytest
import torch

from portbench import compare, harness
from portbench.tests.common import ENCODEC, HIFI, TINY, TOKENIZE, one_thread  # noqa: F401


def prepared(workload, seed=12345):
    ctx = harness.make_context(workload, seed, "cpu", overrides=TINY[workload])
    with torch.no_grad():
        ctx.entry.prepare(ctx)
    return ctx


@pytest.mark.parametrize("workload", [ENCODEC, HIFI, TOKENIZE])
def test_reference_agrees_with_the_port(workload, one_thread):
    ctx = prepared(workload)
    model = ctx.state["program"]
    assert sum(p.numel() for p in model.state_dict().values()) == sum(v.numel() for v in ctx.state["weights"].values())
    with torch.no_grad():
        for i in range(ctx.traffic["batches"]):
            out = ctx.entry.call(ctx, i)
            checks = ctx.entry.judge(ctx, i, out)
            assert checks["code_gap"] == 0.0
            if "wav_err" in checks:  # f32 against a plain bf16 computation: far closer
                assert checks["wav_err"] < 1e-3
            ref = ctx.entry.control_outputs(ctx, i)  # the reference in the program's place, in f32
            assert ctx.entry.judge(ctx, i, ref)["code_gap"] == 0.0
            if out[1] is not None:
                assert torch.allclose(ref[1], out[1], atol=1e-5)


def test_tokens_spread_over_the_codebooks(one_thread):
    ctx = prepared(ENCODEC)
    with torch.no_grad():
        codes, _ = ctx.entry.call(ctx, 0)
    assert all(len(torch.unique(layer)) > 8 for layer in codes)


def test_code_gap_sees_a_changed_token():
    g = torch.Generator().manual_seed(0)
    latents = torch.randn(64, 8, generator=g)
    books = [torch.randn(2, 16, 4, generator=g), torch.randn(2, 16, 4, generator=g) * 0.3]
    # the nearest rows, layer by layer
    r, codes = latents.reshape(64, 2, 4), []
    for book in books:
        idx = torch.stack([torch.cdist(r[:, k], book[k]).argmin(1) for k in range(2)], 1)
        codes.append(idx)
        r = r - torch.stack([book[k][idx[:, k]] for k in range(2)], 1)
    assert compare.code_gaps(latents, books, codes)["code_gap"] == pytest.approx(0.0, abs=1e-6)
    wrong = [c.clone() for c in codes]
    wrong[1][5, 1] = (wrong[1][5, 1] + 1) % 16
    r = compare.code_gaps(latents, books, wrong, clip_frames=[16, 48])  # frame 5 is in the first clip
    assert r["code_gap"] > 1e-3 and r["code_mean"] == pytest.approx(r["code_gap"] / (64 * 2 * 2))
    assert r["clip_mean"] == pytest.approx(r["code_gap"] / (16 * 2 * 2))


def test_wav_err():
    ref = torch.tensor([[0.5, -1.0, 0.25, 0.25]]) + 3.0  # a constant offset does not count
    program = ref + torch.tensor([[0.0, 0.04, 0.0, 0.0]]) + 0.5
    plain = ref + torch.tensor([[0.02, 0.0, 0.0, 0.0]])
    assert compare.ac_err(program, ref) == pytest.approx(0.03 / 1.0)  # AC error 0.03, AC peak 1.0
    assert compare.wav_err(program, ref, plain) == pytest.approx(0.03 / 0.015)
    # the offset that wav_err leaves out: 0.5 + 0.01 over the AC peak 1.0, in units of plain's 0.015
    assert compare.wav_dc(program, ref, plain) == pytest.approx(0.51 / 0.015)
