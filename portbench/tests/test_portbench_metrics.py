"""The metric arithmetic against hand counts: window rates, tails, rooflines, mfu, the trace's busy time."""

import importlib
import math
import statistics
from types import SimpleNamespace

import pytest
import torch

from portbench import bounds, trace
from portbench.families import hificodec, soundstream
from portbench.reference import soundstream as ss_ref

ENCODEC = dict(n_filters=32, dimension=512, ratios=[6, 5, 4, 2], sample_rate=24000,
               target_bandwidths=[1, 2, 4, 8, 12], bins=1024)
HIFI = dict(upsample_rates=[8, 5, 4, 2], upsample_kernel_sizes=[16, 11, 8, 4], upsample_initial_channel=512,
            resblock_kernel_sizes=[3, 7, 11], resblock_dilation_sizes=[[1, 3, 5]] * 3, encoder_base_channels=32)


def reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


def test_window_rate_counts_every_call_over_the_whole_window():
    window = SimpleNamespace(audio_s=16 * 10.0 * 7, window_s=2.0, call_ms=[280.0] * 7, calls=list(range(7)))
    assert reader("audio_s_per_s")(SimpleNamespace(window=window)) == pytest.approx(560.0)


def test_p95_is_the_tail_of_all_calls():
    ms = [float(v) for v in range(1, 101)]  # 100 calls, 1..100 ms
    ctx = SimpleNamespace(window=SimpleNamespace(call_ms=ms))
    assert reader("call_ms_p95")(ctx) == pytest.approx(95.05)
    assert reader("call_ms_p95")(ctx) == statistics.quantiles(ms, n=20, method="inclusive")[18]
    assert reader("call_ms_p95")(SimpleNamespace(window=SimpleNamespace(call_ms=ms[:19]))) is None


def test_kernel_bounds_match_the_kernel_table():
    # PERF.md's kernel table: K1 at N 8000 1.5024 ms, K2 at T 1000 B 8 0.0509 ms, K3 s2 1.0019 / s3 0.5018 ms
    assert bounds.k1_rvq_ms(8000, 1024, 512, 12) == pytest.approx(1.5024, abs=1e-4)
    assert bounds.k2_lstm2_ms(1000, 8, 512, "bfloat16") == pytest.approx(0.0509, abs=1e-4)
    rks, rds = [3, 7, 11], [[1, 3, 5]] * 3
    assert bounds.tower_ms(8, 64, 120000, rks, rds, "bfloat16") == pytest.approx(1.0019, abs=1e-4)
    assert bounds.tower_ms(8, 32, 240000, rks, rds, "bfloat16", c_post=1, kp=7) == pytest.approx(0.5018, abs=1e-4)
    # by hand: K1 is 2 N K D n_q operations at 67 TFLOP/s
    assert bounds.k1_rvq_ms(16000, 1024, 512, 12) == pytest.approx(2 * 16000 * 1024 * 512 * 12 / 67e12 * 1e3)


def test_cells_kernel_calls():
    calls = soundstream.kernel_calls(ENCODEC, 16, 240000, "bfloat16", decode=True)
    assert calls["k1_rvq"] == [pytest.approx(bounds.k1_rvq_ms(16000, 1024, 512, 12))]
    assert len(calls["k2_lstm2"]) == 2
    calls = hificodec.kernel_calls(HIFI, 16, 240000, "bfloat16", decode=True)
    assert calls["k4_gn_tower"] == [pytest.approx(2 * 1.0019, abs=2e-4)]  # [16, 64, 120000]
    assert calls["k3_tower"] == [pytest.approx(2 * 1.0019, abs=2e-4), pytest.approx(2 * 0.5018, abs=2e-4)]
    # lengths: only the valid frames count; f32 at the f32 peak
    masked = hificodec.kernel_calls(HIFI, 2, 240000, "float32", decode=False, valid_samples=[240000, 120000])
    full = bounds.tower_ms(2, 64, 120000, [11, 7, 3], [[1, 3, 5]] * 3, "float32")
    assert masked["k4_gn_tower"][0] == pytest.approx(full * 0.75, rel=1e-4)
    assert masked["k3_tower"] == []


def _ctx_with_trace(group_ms, calls, bounds_per_call, busy_s=0.5, window_s=1.0, launches=100):
    t = trace.Trace(calls=list(range(calls)), window_s=window_s, busy_s=busy_s, group_ms=group_ms,
                    launches=launches)
    entry = SimpleNamespace(kernel_bounds=lambda ctx, i: bounds_per_call)
    return SimpleNamespace(trace=t, entry=entry)


def test_roofline_is_least_time_over_device_time():
    ctx = _ctx_with_trace({"k1_rvq": 8.0}, 2, {"k1_rvq": [3.0]})
    assert reader("k1_rvq_roofline")(ctx) == pytest.approx(75.0)
    assert reader("k2_lstm2_roofline")(ctx) is None  # no K2 in the trace: nothing to read, never 0
    assert reader("launches_per_call")(ctx) == 50
    assert reader("idle_share")(ctx) == pytest.approx(50.0)
    assert reader("k1_rvq_roofline")(SimpleNamespace(trace=None)) is None


def test_mfu_by_hand():
    ctx = SimpleNamespace(device=torch.device("cuda"), traffic={"dtype": "bfloat16"},
                          window=SimpleNamespace(calls=[0, 1, 2, 3], window_s=2.0),
                          model_flops=lambda i: 9.89e12)
    assert reader("mfu")(ctx) == pytest.approx(2.0)  # 4 x 9.89 TFLOP in 2 s over 989 TFLOP/s


def test_model_flops_of_a_conv_and_the_search():
    """The flop counter over the reference on meta tensors: a conv by hand, and the
    search's distance products 2 N K D a layer."""
    sd = bounds.meta_state_dict({"c.weight_v": ((8, 4, 3), "uniform", 12), "c.weight_g": ((8, 1, 1), "x", 0),
                                 "c.bias": ((8,), "uniform", 12)})
    ref = ss_ref.SoundStreamReference.__new__(ss_ref.SoundStreamReference)
    ref.sd, ref.cast = sd, None
    x = torch.empty((1, 4, 100), device="meta")
    assert bounds.count_flops(lambda: ref.sconv("c", x, 3)) == 2 * 100 * 8 * 4 * 3
    r, book = torch.empty((50, 16), device="meta"), torch.empty((32, 16), device="meta")
    assert bounds.count_flops(lambda: ss_ref.nearest(r, book)) == 2 * 50 * 32 * 16


def test_encodec_model_flops_per_audio_second():
    """About 3.5 GFLOP each for the encoder and decoder per audio second, plus the
    12-layer search (PERF.md, profile_port.py --train-flops)."""
    cfg = dict(ENCODEC)
    ref = ss_ref.SoundStreamReference(cfg, bounds.meta_state_dict(ss_ref.param_specs(cfg)))
    wav = torch.empty((1, 24000), device="meta")
    enc = bounds.count_flops(lambda: ref.encoder(wav))
    search = 2 * 100 * 1024 * 512 * 12
    assert enc / 1e9 == pytest.approx(3.49, rel=0.03)
    assert bounds.count_flops(lambda: ref.encode(wav)) == pytest.approx(enc + search)


def test_trace_summary_busy_gaps_and_groups():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start, end, device):
        return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end))

    events = [
        ev(trace.WINDOW, 0.0, 1000.0, cpu),
        ev("portbench.encode", 0.0, 600.0, cpu), ev("aten::conv1d", 100.0, 300.0, cpu),
        ev("rvq_encode_kernel", 50.0, 250.0, cuda),
        ev("void elementwise_kernel", 200.0, 400.0, cuda),  # overlaps the first
        ev("Memcpy DtoH (Device -> Pageable)", 700.0, 800.0, cuda),
        ev("portbench.encode", 10.0, 20.0, cuda),  # the span's device-side annotation: not an operation
    ]
    t = trace.summarize(events, [0, 1])
    assert t.busy_s == pytest.approx(450e-6)  # 50-400 and 700-800
    assert t.window_s == pytest.approx(1000e-6)
    assert t.launches == 2
    assert t.group_ms == pytest.approx({"k1_rvq": 0.2, "elementwise": 0.2, "memcpy": 0.1})
    gaps = dict(t.idle_gaps)
    assert gaps["portbench.encode"] == pytest.approx(50e-6 + 300e-6)  # 0-50 and 400-700, named at their middles
    assert gaps["between calls"] == pytest.approx(200e-6)  # 800-1000
    assert math.isclose(sum(gaps.values()) + t.busy_s, t.window_s)
