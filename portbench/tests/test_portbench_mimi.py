"""The Mimi cell's parts: the family's layout, the stacked chain the check follows,
the transformers' bound, the reference's FLOP count at the band, and a whole run
at a tiny width on the CPU (correct, and not correct when broken)."""

import json
import math

import pytest
import torch

from portbench import bounds, compare, harness
from portbench.entries import codec
from portbench.faults import half_batch, post_bias_dropped, sample_altered, token_altered
from portbench.families import mimi
from portbench.tests.common import ROOT, one_thread, python  # noqa: F401

MIMI = "mimi_24k_1920d.roundtrip_bf16_b8_20s"
TINY = {"config": dict(num_filters=4, hidden_size=32, upsampling_ratios=[2, 2], sampling_rate=200,
                       num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, sliding_window=6,
                       num_quantizers=4, codebook_dim=8, codebook_size=16),
        "traffic": dict(batch=2, clip_seconds=[1.5, 1.5], bucket_seconds=1.5, batches=2, trace_calls=2,
                        dtype="float32")}  # 75 frames at the transformers: the window binds, two query blocks
CONFIG = harness.load_json(harness.ROOT / "configs" / "mimi_24k_1920d.json")


def test_code_layout_round_trip():
    codes = torch.arange(4 * 3 * 5).reshape(4, 3, 5)
    per_row = [mimi.row_slice(codes, b, b + 1)[:, :, : 5 - b] for b in range(3)]
    joined = mimi.join_rows(per_row, 5)
    for b in range(3):
        assert torch.equal(joined[:, b, : 5 - b], codes[:, b, : 5 - b]) and not joined[:, b, 5 - b:].any()
    layers = mimi.codes_by_layer(codes, [0, 2], [5, 3])
    assert len(layers) == 4 and torch.equal(layers[1][:, 0], torch.cat([codes[1, 0], codes[1, 2, :3]]))
    assert mimi.frames_for(CONFIG, 480000) == 250 and mimi.frames_for(CONFIG, 480001) == 251


def test_the_stacked_chain_gaps_are_the_two_chains_gaps():
    """One residual chain over the two parts' latents side by side, each part's codebooks
    zero-padded into the other's half: every excess is the part's own."""
    g = torch.Generator().manual_seed(0)
    N, c, K = 50, 6, 12
    first, rest = torch.randn(N, c, generator=g), torch.randn(N, c, generator=g)
    books_f = [torch.randn(1, K, c, generator=g)]
    books_r = [torch.randn(1, K, c, generator=g) * s for s in (1.0, 0.5, 0.25)]
    codes_f = [torch.randint(K, (N, 1), generator=g)]  # some right, most wrong
    codes_r = [torch.randint(K, (N, 1), generator=g) for _ in books_r]
    zeros = torch.zeros(1, K, c)
    stacked = compare.code_gaps(torch.cat([first, rest], 1),
                                [torch.cat([b, zeros], 2) for b in books_f] + [torch.cat([zeros, b], 2) for b in books_r],
                                codes_f + codes_r)
    gf, gr = compare.code_gaps(first, books_f, codes_f), compare.code_gaps(rest, books_r, codes_r)

    def spread(z):
        return float((z - z.mean(0)).square().sum(1).mean())

    sf, sr = spread(first), spread(rest)
    assert stacked["code_gap"] * (sf + sr) == pytest.approx(max(gf["code_gap"] * sf, gr["code_gap"] * sr), rel=1e-5)
    assert stacked["code_mean"] * 4 * (sf + sr) == pytest.approx(gf["code_mean"] * sf + 3 * gr["code_mean"] * sr,
                                                                 rel=1e-5)
    assert stacked["code_gap"] > 0


def test_the_transformers_bound():
    """At the cell's shape: 2 x 4,000 tokens x 3,145,728 weights x 16 layers, plus
    4 x 12,016,000 pairs x 512, at the bf16 peak: ~0.43 ms a call."""
    assert mimi.layer_weights(CONFIG) == 3_145_728
    assert mimi.band_pairs(500, 250) == 93_875
    flops, nbytes = mimi.transformer_work(CONFIG, 8, 480000, True, 2)
    assert flops == 2 * 4000 * 3_145_728 * 16 + 4 * 12_016_000 * 512
    assert nbytes == 2 * 16 * (3_145_728 + 2 * 4000 * 512)
    ms = mimi.transformer_ms(CONFIG, 8, 480000, "bfloat16", True)
    assert ms == pytest.approx(flops / 989e12 * 1e3) and 0.42 < ms < 0.44
    assert mimi.transformer_ms(CONFIG, 8, 480000, "bfloat16", False) < ms / 1.9  # encode alone: one transformer


def test_k1_calls_are_the_two_parts():
    calls = mimi.kernel_calls(CONFIG, 8, 480000, "bfloat16", True)["k1_rvq"]
    assert calls == [pytest.approx(bounds.k1_rvq_ms(2000, 2048, 256, 1)),
                     pytest.approx(bounds.k1_rvq_ms(2000, 2048, 256, 31))]


def test_the_reference_counts_the_band():
    """On meta tensors at a tiny width: the matmuls' operations and 4 x pairs x D a
    layer for the window's pairs, not T^2."""
    cfg = {**CONFIG, **TINY["config"]}
    ref = mimi.Reference(cfg, bounds.meta_state_dict(mimi.specs(cfg)))
    T, D, L = 75, 32, 2
    x = torch.empty(1, D, T, device="meta")
    counted = bounds.count_flops(lambda: ref.transformer("encoder_transformer", x))
    band = sum(min(t + 1, 6) for t in range(T))
    assert counted == L * (2 * T * mimi.layer_weights(cfg) + 4 * band * D)
    assert counted < L * (2 * T * mimi.layer_weights(cfg) + 4 * T * T * D)


def test_the_specs_are_the_programs_state_dict(one_thread):
    from academicodec_tpu_torch.api import load_codec

    cfg = {**CONFIG, **TINY["config"]}
    model = load_codec("mimi_24k_1920d", device="cpu",
                       **{k: tuple(cfg[c]) if isinstance(cfg[c], list) else cfg[c] for k, c in mimi.KEYS.items()})
    specs = mimi.specs(cfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: s for k, (s, _, _) in specs.items()}
    assert mimi.post_bias(cfg) == "decoder.model.8.conv.conv.bias" and mimi.post_bias(CONFIG).startswith(
        "decoder.model.14.")


def test_the_cell_is_correct_at_a_tiny_width(one_thread):
    r = harness.run(MIMI, 3000000019, 0.05, False, "cpu", overrides=TINY)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) >= {"audio_s_per_s.roundtrip", "setup_s"}
    assert r["checks"]["code_gap"]["value"] == 0.0 and r["checks"]["wav_err"]["value"] < 1e-3
    ctx = harness.make_context(MIMI, 5, "cpu", overrides=TINY)
    with torch.no_grad():
        ctx.entry.prepare(ctx)
        codes, _ = ctx.entry.call(ctx, 0)
        ref = ctx.entry.control_outputs(ctx, 0)  # the reference in the program's place
    assert torch.equal(ref[0], codes)
    assert all(len(torch.unique(layer)) > 4 for layer in codes)


@pytest.mark.parametrize("fault", [half_batch, token_altered, sample_altered, post_bias_dropped])
def test_a_broken_call_is_not_correct(fault, monkeypatch, one_thread):
    call = codec.call
    monkeypatch.setattr(codec, "call", lambda ctx, i: fault(ctx, call(ctx, i)))
    broken = harness.run(MIMI, 21, 0.05, False, "cpu", overrides=TINY)
    assert broken["correct"] is False, broken["checks"]


def test_the_cells_files_and_entries():
    bench = harness.load_json(harness.ROOT.parent / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == MIMI)
    traffic = harness.load_json(harness.ROOT / "traffic" / f"{cell['traffic']}.json")
    assert traffic["batch"] * traffic["clip_seconds"][1] == 160  # the other roundtrips' audio a call
    assert math.ceil(traffic["clip_seconds"][1] * 25) == 500 > CONFIG["sliding_window"]
    new = {m["name"] for m in bench["per_layer"] if m.get("workloads") == [MIMI]}
    assert new == {"transformer_ms_per_call.roundtrip", "transformer_roofline.roundtrip"}


CHECK_MODULES = """
import json, sys, torch
torch.set_num_threads(1)
import portbench.reference.mimi
tops_ref = sorted({n.split('.')[0] for n in sys.modules})
from portbench import harness
from portbench.tests.test_portbench_mimi import MIMI, TINY
for trace in (False, True):
    assert harness.run(MIMI, 7, 0.05, trace, "cpu", overrides=TINY)["correct"]
print(json.dumps({"ref": tops_ref, "forbidden": harness.forbidden_modules(),
                  "port": "academicodec_tpu_torch.models.mimi" in sys.modules}))
"""


def test_the_cells_path_loads_no_jax_and_the_reference_loads_torch_alone():
    """In a fresh process: the reference imports nothing of the port, and a whole run of
    the cell loads no module whose top-level name is jax, jaxlib, flax or academicodec_tpu."""
    out = python(CHECK_MODULES)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"academicodec_tpu_torch", "academicodec_tpu", "jax", "flax"} & set(got["ref"])
    assert got["forbidden"] == [] and got["port"]
    assert "import academicodec" not in (ROOT / "portbench" / "reference" / "mimi.py").read_text()
