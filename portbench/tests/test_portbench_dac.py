"""The DAC cell's parts: the family's layout and launches, the judge that follows DAC's
search, the Snake metrics' readers, and a whole run at a tiny width on the CPU
(correct, and not correct when broken)."""

import json
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, inputs, spans
from portbench.entries import codec
from portbench.faults import half_batch, post_bias_dropped, sample_altered, token_altered
from portbench.families import dac
from portbench.tests.common import ROOT, one_thread, python  # noqa: F401

DAC = "dac_44k_512d.roundtrip_fvq_bf16_b16"
TINY = {"config": dict(encoder_hidden_size=4, downsampling_ratios=[2, 2], hidden_size=16, decoder_hidden_size=16,
                       upsampling_ratios=[2, 2], n_codebooks=3, codebook_size=16, codebook_dim=4, sampling_rate=400),
        "traffic": dict(batch=2, clip_seconds=[1.0, 1.0], bucket_seconds=1.0, batches=2, trace_calls=2,
                        dtype="float32")}  # 100 frames of 4 samples a clip
CONFIG = harness.load_json(harness.ROOT / "configs" / "dac_44k_512d.json")


def _read(name, ctx):
    import importlib

    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def test_the_layout_and_the_published_launches():
    assert dac.frames_for(CONFIG, 441000) == 862 and dac.frames_for(CONFIG, 441344) == 862
    launches = dac.snake_launches(CONFIG, 441000, True)
    assert len(launches) == 58 and len(dac.snake_launches(CONFIG, 441000, False)) == 29
    elements = sum(16 * l.channels * l.frames for l in launches)
    assert 20.7e9 < elements < 20.9e9
    flops, nbytes = dac.snake_work(CONFIG, 16, 441000, True, 2)
    assert flops == 8 * elements and 4 * elements < nbytes < 6 * elements  # x and y, some residuals and sums
    assert dac.snake_ms(CONFIG, 16, 441000, "bfloat16", True) == pytest.approx(nbytes / 3.35e12 * 1e3)  # bytes bind
    assert dac.post_bias(CONFIG) == "decoder.model.6.bias"
    assert dac.kernel_calls(CONFIG, 16, 441000, "bfloat16", True) == {}


def test_the_specs_are_the_programs_state_dict(one_thread):
    from academicodec_tpu_torch.api import load_codec

    cfg = {**CONFIG, **TINY["config"]}
    model = load_codec("dac_44k_512d", device="cpu",
                       **{k: tuple(cfg[c]) if isinstance(cfg[c], list) else cfg[c] for k, c in dac.KEYS.items()})
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: s for k, (s, _, _) in dac.specs(cfg).items()}
    full = dac.specs(CONFIG)
    assert sum(int(torch.Size(s).numel()) for s, _, _ in full.values()) == pytest.approx(76e6, rel=0.02)


def test_snake_work_is_the_models_launches(monkeypatch, one_thread):
    """Every epilogue a tiny roundtrip runs, its elements, residual and kept sum as the
    program calls it, against ``snake_launches`` / ``snake_work`` from the configuration."""
    from academicodec_tpu_torch.nn import dac as dac_nn

    seen = []
    plain = dac_nn.snake_ops.snake

    def record(h, alpha, bias, residual, keep_sum, frames):
        seen.append((h.numel(), residual is not None, keep_sum))
        return plain(h, alpha, bias, residual, keep_sum, frames)

    monkeypatch.setattr(dac_nn.snake_ops, "snake", record)
    cfg = {**CONFIG, **TINY["config"]}
    model = dac.build_program(cfg, inputs.seeded_state_dict(dac.specs(cfg), 1, "cpu"), torch.float32, "cpu")
    with torch.no_grad():
        model.decode(model.encode(torch.randn(3, 399)))
    want = dac.snake_launches(cfg, 399, True)
    assert seen == [(3 * l.channels * l.frames, l.residual, l.keeps_sum) for l in want]
    assert sum(n * 4 * (2 + r + k) for n, r, k in seen) == dac.snake_work(cfg, 3, 399, True, 4)[1]


def test_the_judge_follows_dacs_search(one_thread):
    """The reference's own codes read 0; one token moved to another row raises ``code_gap``
    at that layer (and only there: the layers after it are judged along the moved token)."""
    ctx = harness.make_context(DAC, 11, "cpu", overrides=TINY)
    with torch.no_grad():
        ctx.entry.prepare(ctx)
        own = ctx.entry.control_outputs(ctx, 0)
        assert all(len(torch.unique(layer)) > 4 for layer in own[0])
        got = ctx.entry.judge(ctx, 0, own)
        assert got["code_gap"] == 0.0 and got["code_mean"] == 0.0 and got["wav_err"] < 1e-3
        moved = own[0].clone()
        moved[1, 0, 30] = (moved[1, 0, 30] + 1) % 16
        broken = ctx.entry.judge(ctx, 0, (moved, own[1]))
    assert broken["code_gap"] > 1e-3 and broken["code_mean"] > 0


def test_the_snake_readers_read_the_spans_block():
    stages = spans.Stages(calls=2, window_s=1.0, busy_s=0.9, device_ms={"codec.snake": 100.0, "codec.encoder": 60.0},
                          idle_ms={}, unlinked=0)
    wav = torch.zeros(16, 441000)
    ctx = SimpleNamespace(state={"spans": stages, "batches": [(wav, None)]}, family=dac, config=CONFIG,
                          traffic={"trace_calls": 2, "dtype": "bfloat16", "decode": True},
                          trace=SimpleNamespace(calls=[5, 6]))
    assert _read("snake_ms_per_call", ctx) == 50.0
    least = dac.snake_ms(CONFIG, 16, 441000, "bfloat16", True)
    assert _read("snake_roofline", ctx) == pytest.approx(100.0 * least / 50.0)
    assert 30 < least < 40  # ~119 GB at 3.35 TB/s
    empty = SimpleNamespace(**{**vars(ctx), "state": {**ctx.state, "spans": spans.Stages(
        calls=2, window_s=1.0, busy_s=0.9, device_ms={"codec.encoder": 60.0}, idle_ms={}, unlinked=0)}})
    assert _read("snake_ms_per_call", empty) is None and _read("snake_roofline", empty) is None
    other = SimpleNamespace(**{**vars(ctx), "family": SimpleNamespace()})  # a family without the bound
    assert _read("snake_roofline", other) is None


def test_the_cell_is_correct_at_a_tiny_width(one_thread):
    r = harness.run(DAC, 3000000019, 0.05, False, "cpu", overrides=TINY)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) >= {"audio_s_per_s.roundtrip", "setup_s"}
    assert r["checks"]["code_gap"]["value"] == 0.0 and r["checks"]["wav_err"]["value"] < 1e-3


@pytest.mark.parametrize("fault", [half_batch, token_altered, sample_altered, post_bias_dropped])
def test_a_broken_call_is_not_correct(fault, monkeypatch, one_thread):
    call = codec.call
    from portbench.entries import codec_fvq

    monkeypatch.setattr(codec_fvq, "call", lambda ctx, i: fault(ctx, call(ctx, i)))
    broken = harness.run(DAC, 21, 0.05, False, "cpu", overrides=TINY)
    assert broken["correct"] is False, broken["checks"]


def test_the_cells_files_and_entries():
    bench = harness.load_json(harness.ROOT.parent / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == DAC)
    assert cell["chips"] == 1 and cell["config"] == "dac_44k_512d"
    traffic = harness.load_json(harness.ROOT / "traffic" / f"{cell['traffic']}.json")
    assert traffic["entry"] == "codec_fvq" and traffic["batch"] * traffic["clip_seconds"][1] == 160
    new = {m["name"] for m in bench["per_layer"] if m.get("workloads") == [DAC]}
    assert new == {"snake_ms_per_call.roundtrip", "snake_roofline.roundtrip"}
    limits = json.loads((harness.ROOT / "limits" / f"{DAC}.json").read_text())
    assert set(limits) == {"code_gap", "code_mean", "clip_mean", "wav_err", "wav_dc"}


CHECK_MODULES = """
import json, sys, torch
torch.set_num_threads(1)
import portbench.reference.dac
tops_ref = sorted({n.split('.')[0] for n in sys.modules})
from portbench import harness
from portbench.tests.test_portbench_dac import DAC, TINY
for trace in (False, True):
    assert harness.run(DAC, 7, 0.05, trace, "cpu", overrides=TINY)["correct"]
print(json.dumps({"ref": tops_ref, "forbidden": harness.forbidden_modules(),
                  "port": "academicodec_tpu_torch.models.dac" in sys.modules}))
"""


def test_the_cells_path_loads_no_jax_and_the_reference_loads_torch_alone():
    """In a fresh process: the reference imports nothing of the port, and a whole run of
    the cell loads no module whose top-level name is jax, jaxlib, flax or academicodec_tpu."""
    out = python(CHECK_MODULES)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"academicodec_tpu_torch", "academicodec_tpu", "jax", "flax"} & set(got["ref"])
    assert got["forbidden"] == [] and got["port"]
    assert "import academicodec" not in (ROOT / "portbench" / "reference" / "dac.py").read_text()
