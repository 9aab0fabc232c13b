"""The spans block's reduction (``portbench/spans.py``) on a hand-built event list,
and its readers: exact stage and idle ms, nothing read without a card."""

import importlib
from types import SimpleNamespace

import pytest
import torch

from portbench import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end), id=id,
                           is_user_annotation=annotation)


# two calls in a 1000 us window (times in us): an encode, the benchmark's copy to
# the host, a decode
EVENTS = [
    ev(trace.WINDOW, 0.0, 1000.0),
    ev("portbench.encode", 0.0, 420.0),
    ev("codec.encode", 10.0, 400.0), ev("codec.upload", 10.0, 100.0),
    ev("cudaMemcpyAsync", 20.0, 95.0, id=1), ev("Memcpy HtoD (Pageable -> Device)", 30.0, 90.0, CUDA, id=1),
    ev("codec.encoder", 100.0, 250.0), ev("aten::conv1d", 110.0, 200.0),
    ev("cudaLaunchKernel", 120.0, 125.0, id=2), ev("sm90_xmma_fprop_kernel", 130.0, 230.0, CUDA, id=2),
    # launched through ctypes: a CUDA API call under no aten operator
    ev("codec.quantize", 250.0, 400.0), ev("cuLaunchKernel", 260.0, 262.0, id=3),
    ev("rvq_encode_kernel", 260.0, 380.0, CUDA, id=3),
    ev("codec.encode", 10.0, 400.0, CUDA, annotation=True),  # the spans' device-side annotations
    ev("portbench.encode", 10.0, 400.0, CUDA),
    ev("portbench.to_host", 420.0, 500.0), ev("cudaMemcpyAsync", 425.0, 485.0, id=4),
    ev("Memcpy DtoH (Device -> Pageable)", 430.0, 480.0, CUDA, id=4),
    ev("codec.decode", 500.0, 900.0), ev("codec.dequantize", 505.0, 600.0),
    ev("cudaLaunchKernel", 520.0, 522.0, id=5), ev("indexSelectLargeIndex", 540.0, 560.0, CUDA, id=5),
    ev("codec.decoder", 600.0, 890.0), ev("cudaLaunchKernel", 610.0, 612.0, id=6),
    ev("tower_kernel<64, false>", 620.0, 800.0, CUDA, id=6),
    ev("elementwise_kernel", 850.0, 870.0, CUDA, id=99),  # its launch is not in the trace
]


def test_reduction_by_launch_and_gap_middles():
    s = spans.reduce(EVENTS, 2)
    assert s.window_s == pytest.approx(1000e-6) and s.busy_s == pytest.approx(550e-6)
    assert s.device_ms == pytest.approx({"codec.upload": 0.06, "codec.encoder": 0.1, "codec.quantize": 0.12,
                                         spans.OUTSIDE: 0.05, "codec.dequantize": 0.02, "codec.decoder": 0.2})
    # 0-30 in the upload; 90-130, 230-260 in the encoder; 380-430 between calls; 480-540,
    # 560-620 in the dequantize; 800-850 in the decoder; 870-1000 after the calls
    assert s.idle_ms == pytest.approx({"codec.upload": 0.03, "codec.encoder": 0.07, spans.OUTSIDE: 0.18,
                                       "codec.dequantize": 0.12, "codec.decoder": 0.05})
    assert s.unlinked == 1
    assert sum(s.device_ms.values()) == pytest.approx(s.busy_s * 1e3)
    assert sum(s.idle_ms.values()) == pytest.approx((s.window_s - s.busy_s) * 1e3)


def test_an_inner_span_that_starts_with_its_parent_holds_its_launches():
    events = [ev(trace.WINDOW, 0.0, 100.0), ev("codec.encode", 10.0, 90.0), ev("codec.upload", 10.0, 50.0),
              ev("cudaMemcpyAsync", 10.0, 12.0, id=1), ev("Memcpy HtoD", 20.0, 40.0, CUDA, id=1)]
    assert spans.reduce(events, 1).device_ms == {"codec.upload": pytest.approx(0.02)}


def read(name, ctx):
    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def test_readers_per_call():
    ctx = SimpleNamespace(state={"spans": spans.reduce(EVENTS, 2)})
    assert read("encoder_ms_per_call", ctx) == pytest.approx(0.05)
    assert read("quantizer_ms_per_call", ctx) == pytest.approx(0.07)  # quantize and dequantize
    assert read("decoder_ms_per_call", ctx) == pytest.approx(0.1)
    assert read("program_idle_ms_per_call", ctx) == pytest.approx(0.135)  # 270 us in program spans, 2 calls


def test_a_block_without_a_stage_reads_nothing_for_it():
    encode_only = [e for e in EVENTS if e.time_range.start < 420.0]
    ctx = SimpleNamespace(state={"spans": spans.reduce(encode_only, 1)})
    assert read("decoder_ms_per_call", ctx) is None
    outside = [ev(trace.WINDOW, 0.0, 10.0), ev("k", 2.0, 4.0, CUDA, id=1)]
    assert read("program_idle_ms_per_call", SimpleNamespace(state={"spans": spans.reduce(outside, 1)})) is None


@pytest.mark.parametrize("name", ["encoder_ms_per_call", "quantizer_ms_per_call", "decoder_ms_per_call",
                                  "program_idle_ms_per_call", "program_load_s"])
def test_no_card_no_reading(name):
    ctx = SimpleNamespace(device=torch.device("cpu"), trace=None, state={})
    assert read(name, ctx) is None


def test_program_load_leaves_out_a_build(monkeypatch):
    from academicodec_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "REGISTRY", profiling.Registry())
    card = SimpleNamespace(device=SimpleNamespace(type="cuda"), state={})
    assert read("program_load_s", card) is None  # nothing loaded yet
    profiling.REGISTRY.add("codec.load", 1, 500_000_000)
    profiling.REGISTRY.add("kernels.load", 1, 100_000_000)
    assert read("program_load_s", card) == pytest.approx(0.6)
    profiling.REGISTRY.add("kernels.load", 1, 40_000_000_000)  # a load that built the library
    profiling.REGISTRY.add("kernels.builds", 1, 39_900_000_000)
    assert read("program_load_s", card) == pytest.approx(0.7)
