"""The port's spans and counters (``utils/profiling.py``): stage spans of tiny
SoundStream and HiFi-Codec calls, counted always and on the profiler's timeline
only when switched on; ``codec.load``; the launch counters, kept in the registry
alone; the registry under threads."""

import inspect
import sys
import threading

import pytest
import torch

import chip_smoke
from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.models.hificodec import VQVAE
from academicodec_tpu_torch.models.soundstream import SoundStream
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.ops import int8 as int8_ops
from academicodec_tpu_torch.ops.cuda import chain as chain_ops
from academicodec_tpu_torch.ops.cuda import lstm as lstm_ops
from academicodec_tpu_torch.ops.cuda import resblock as rb_ops
from academicodec_tpu_torch.ops.cuda import rvq as rvq_ops
from academicodec_tpu_torch.utils import profiling

SS_TINY = dict(n_filters=4, dimension=32, ratios=(2, 2), sample_rate=400, target_bandwidths=(1, 2), bins=64)
HF_TINY = dict(upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=32,
               encoder_base_channels=8, n_codes=64, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
PROGRAM = ("codec.", "kernels.", "train.")
ENCODE = ("codec.upload", "codec.encoder", "codec.quantize")
DECODE = ("codec.upload", "codec.dequantize", "codec.decoder")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def models():
    return {"soundstream": SoundStream(**SS_TINY, device="cpu"),
            "vqvae": VQVAE(HiFiCodecConfig(**HF_TINY), device="cpu")}


def _calls(models, name):
    """(root span, stage spans, the call) of each public call of one model."""
    model = models[name]
    wav = torch.randn(2, 640, generator=torch.Generator().manual_seed(0))
    codes = model.encode(wav)
    calls = [("codec.encode", ENCODE, lambda: model.encode(wav)),
             ("codec.decode", DECODE, lambda: model.decode(codes))]
    if name == "vqvae":
        calls.append(("codec.encode", ENCODE, lambda: model.encode(wav, lengths=torch.tensor([640, 300]))))
    return calls


def _delta(before, after):
    return {k: after[k].count - before.get(k, profiling.Total(0, 0.0)).count for k in after
            if after[k].count != before.get(k, profiling.Total(0, 0.0)).count}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith(PROGRAM)]


@pytest.mark.parametrize("name", ["soundstream", "vqvae"])
def test_each_call_counts_its_root_and_stages_once(models, name):
    for root, stages, call in _calls(models, name):
        before = profiling.totals()
        call()
        got = _delta(before, profiling.totals())
        assert got == {root: 1, **{s: 1 for s in stages}}, root
        assert all(profiling.total(s).seconds > 0 for s in (root, *stages))


@pytest.mark.parametrize("name", ["soundstream", "vqvae"])
def test_spans_reach_the_profiler_only_when_switched_on(models, name):
    for root, stages, call in _calls(models, name):
        assert _profiled(call) == []  # off: no program event, whatever the profiler records
        with profiling.spans_on():
            events = _profiled(call)
        assert not profiling.REGISTRY.spans_on
        assert sorted(e[0] for e in events) == sorted((root, *stages))
        (_, r0, r1), = [e for e in events if e[0] == root]
        kids = sorted(e for e in events if e[0] != root)
        assert all(r0 <= a <= b <= r1 for _, a, b in kids)  # each stage nested in its root
        assert [e[0] for e in sorted(kids, key=lambda e: e[1])] == list(stages)  # in the call's order


def test_enable_and_trace_switch_spans(tmp_path):
    def one_span():
        with profiling.span("train.step"):
            pass

    with profiling.spans_on():
        with profiling.spans_on():
            assert [e[0] for e in _profiled(one_span)] == ["train.step"]
        assert profiling.REGISTRY.spans_on  # an inner block leaves the outer one's switch on
    assert _profiled(one_span) == []
    with profiling.trace(str(tmp_path)):
        assert profiling.REGISTRY.spans_on
    assert not profiling.REGISTRY.spans_on


def test_codec_load_once_per_load_codec(tmp_path):
    for preset, kw in (("encodec_24k_240d", SS_TINY), ("hificodec_24k_320d", HF_TINY)):
        before = profiling.total("codec.load")
        model = load_codec(preset, device="cpu", **kw)
        assert profiling.total("codec.load").count == before.count + 1
        ckpt = tmp_path / f"{preset}.pt"
        torch.save(model.reference_state_dict() if isinstance(model, VQVAE) else model.state_dict(), ckpt)
        before = profiling.total("codec.load")
        load_codec(preset, str(ckpt), device="cpu", **kw)  # with its weights: still one span
        assert profiling.total("codec.load").count == before.count + 1


def test_a_decorated_function_keeps_its_name_and_counts_each_call():
    @profiling.span("train.step")
    def step(n):
        """A step."""
        return n + 1

    before = profiling.total("train.step").count
    assert [step(i) for i in range(3)] == [1, 2, 3]
    assert profiling.total("train.step").count == before + 3
    assert step.__name__ == "step" and step.__doc__ == "A step."


@pytest.mark.parametrize("module, attr, counter", [
    (rvq_ops, "LAUNCHES", "k1.launches"), (lstm_ops, "LAUNCHES", "k2.launches"),
    (rb_ops, "TOWER_LAUNCHES", "k3.launches"), (rb_ops, "GN_TOWER_LAUNCHES", "k4.launches"),
    (chain_ops, "P1_LAUNCHES", "p1.launches"), (chain_ops, "P2_LAUNCHES", "p2.launches"),
    (int8_ops, "INT_MM_CALLS", "int8.gemms"),
])
def test_launch_attributes_read_and_write_the_registry(module, attr, counter):
    """Each wrapper counts its launches in the registry alone (its module keeps no
    counter of its own, as it did before the registry); ``chip_smoke`` reads each
    counter, and its ``reset_launches`` zeroes K1-K4's and the GEMM's and no other."""
    assert not hasattr(module, attr) and f'"{counter}"' in inspect.getsource(module)
    saved = profiling.totals()
    try:
        profiling.count(counter, 3)
        profiling.count("codec.load")
        before = profiling.totals()
        read = {**chip_smoke.read_launches(), **chip_smoke.read_probe_launches()}
        read = {c: read[k] for k, c in {**chip_smoke.LAUNCH_COUNTERS, **chip_smoke.PROBE_COUNTERS}.items()}
        assert {**read, "int8.gemms": chip_smoke.int8_gemms()}[counter] == before[counter].count
        chip_smoke.reset_launches()
        after = profiling.totals()
        assert (counter in after) == (counter in chip_smoke.PROBE_COUNTERS.values())
        assert after["codec.load"] == before["codec.load"]
    finally:
        profiling.reset()
        for name, t in saved.items():
            profiling.REGISTRY.add(name, t.count, int(t.seconds * 1e9))


def test_registry_under_threads_loses_no_update():
    before = profiling.total("test.threads").count
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                with profiling.span("test.threads"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert profiling.total("test.threads").count == before + 16 * 2000


def test_reset_clears_every_total():
    saved = profiling.totals()
    try:
        profiling.count("test.reset")
        profiling.reset()
        assert profiling.totals() == {} and profiling.total("k1.launches").count == 0
    finally:
        for name, t in saved.items():
            profiling.REGISTRY.add(name, t.count, int(t.seconds * 1e9))
