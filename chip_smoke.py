#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Builds the hand-written kernels from ``academicodec_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the port's
main path: the flagship Encodec_24k_240d roundtrip (wav -> SEANet encoder
-> RVQ encode -> RVQ decode -> SEANet decoder -> wav) in bf16 at batch
8 x 10 s, with seeded random weights and N(0, 1) codebooks. Any failed
phase exits non-zero; without a CUDA device it exits 1 at once.

    python3 chip_smoke.py

Output ends with three lines: a JSON object of every kernel's numbers, the
card's name and power limit from nvidia-smi, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The phase functions take the device and the model's overrides as
arguments, so a CPU test can rehearse the main path at a tiny width.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys

import torch

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.nn.lstm import SLSTM
from academicodec_tpu_torch.ops.cuda import build as kernel_build
from academicodec_tpu_torch.ops.cuda import lstm as lstm_ops
from academicodec_tpu_torch.ops.cuda import rvq as rvq_ops

# NVIDIA H100 SXM data-sheet peaks (dense), at its full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

FLAGSHIP = "encodec_24k_240d"


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak_flops: float):
    """Least time (ms) the card could take, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device() -> str:
    smi = nvidia_smi()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    path, log = kernel_build.build()
    print(f"[build] {path.relative_to(kernel_build.CSRC.parent.parent)} "
          f"(nvcc {' '.join(kernel_build.NVCC_FLAGS)})")
    for line in log.splitlines():
        if line.startswith("==") or "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    kernel_build.load_library()


def phase_rvq(device, n=8000, d=512, k=1024, n_q=12, ragged_n=75, iters=10) -> dict:
    """K1 against its plain version at the flagship shape and at a ragged N."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=device)
    embed = torch.randn((n_q, k, d), generator=g, device=device)
    codes, ref = rvq_ops.rvq_encode(x, embed), rvq_ops.rvq_encode_plain(x, embed)
    mismatch = (codes != ref).double().mean().item()
    max_abs_err = (codes.long() - ref.long()).abs().max().item()
    xr = x[:ragged_n].clone()
    codes_r = rvq_ops.rvq_encode(xr, embed)
    mismatch_ragged = (codes_r != rvq_ops.rvq_encode_plain(xr, embed)).double().mean().item()
    ms = time_ms(lambda: rvq_ops.rvq_encode(x, embed), iters)
    plain_ms = time_ms(lambda: rvq_ops.rvq_encode_plain(x, embed), 3)
    nbytes = 4.0 * (n * d + n_q * k * d + n_q * n)
    bound_ms, bound_by = bound(2.0 * n * k * d * n_q, nbytes, PEAK_F32_FLOPS)
    print(f"[rvq] [{n},{d}] x [{n_q},{k},{d}]: token mismatch {mismatch:.3g} (limit 1e-4), "
          f"ragged N={ragged_n}: {mismatch_ragged:.3g} (limit 0)")
    print(f"[rvq] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not (mismatch <= 1e-4 and mismatch_ragged == 0.0):
        raise AssertionError("rvq_encode disagrees with rvq_encode_plain")
    return dict(
        name="rvq_encode", route="cuda", source="academicodec_tpu_torch/csrc/rvq.cu",
        replaces="academicodec_tpu/ops/pallas/rvq.py:34", max_abs_err=float(max_abs_err),
        token_mismatch=mismatch, tolerance="token mismatch <= 1e-4 (0 at N=75)",
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )


def phase_lstm(device, B=8, T=1000, H=512, ragged_t=70, iters=5) -> dict:
    """K2 against its plain version: bf16 at the flagship shape, f32 at a ragged T."""
    slstm = SLSTM(H)
    slstm.lstm.reset_parameters(torch.Generator().manual_seed(1))
    g = torch.Generator(device=device).manual_seed(1)
    errs, bf16_case = {}, None
    for dtype, steps, tol in ((torch.bfloat16, T, 1e-2), (torch.float32, ragged_t, 1e-4)):
        mod = copy.deepcopy(slstm).to(device=device, dtype=dtype)
        x = (torch.randn((B, H, steps), generator=g, device=device) * 0.5).to(dtype)
        with torch.no_grad():
            args = mod.recurrence_inputs(x)
            y = lstm_ops.lstm2(*args, out_dtype=dtype).float()
            ref = lstm_ops.lstm2_plain(*args, out_dtype=dtype).float()
        errs[dtype] = (y - ref).abs().max().item()
        print(f"[lstm2] {dtype} [{B},{steps},{H}]: max abs diff {errs[dtype]:.3g} (atol {tol})")
        if not torch.allclose(y, ref, atol=tol, rtol=tol if dtype == torch.bfloat16 else 0.0):
            raise AssertionError(f"lstm2 disagrees with lstm2_plain in {dtype}")
        if dtype == torch.bfloat16:
            bf16_case = (mod, x, args)
    mod, x, args = bf16_case
    with torch.no_grad():
        ms = time_ms(lambda: lstm_ops.lstm2(*args, out_dtype=torch.bfloat16), iters)
        plain_ms = time_ms(lambda: lstm_ops.lstm2_plain(*args, out_dtype=torch.bfloat16), 2)
        # yardstick only: cuDNN's 2-layer LSTM on the same weights and input
        # (it also computes the layer-1 input projection); the port never calls it
        ref_lstm = torch.nn.LSTM(H, H, num_layers=2).to(device=device, dtype=torch.bfloat16)
        ref_lstm.load_state_dict({k[len("lstm."):]: v for k, v in mod.state_dict().items()})
        ref_lstm.flatten_parameters()
        xt = x.permute(2, 0, 1).contiguous()
        library_ms = time_ms(lambda: ref_lstm(xt), iters)
    nbytes = T * B * 4 * H * 4 + 3 * 4 * H * H * 2 + 4 * H * 4 + T * B * H * 2
    bound_ms, bound_by = bound(2.0 * 3 * 4 * H * H * B * T, nbytes, PEAK_BF16_FLOPS)
    print(f"[lstm2] kernel {ms:.4f} ms ({ms / (T + 1) * 1e3:.2f} us per step), plain {plain_ms:.4f} ms, "
          f"cuDNN LSTM {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(
        name="lstm2", route="cuda", source="academicodec_tpu_torch/csrc/lstm2.cu",
        replaces="academicodec_tpu/ops/pallas/lstm.py:36", max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32_ragged=errs[torch.float32],
        tolerance="atol/rtol 1e-2 in bf16, atol 1e-4 in f32",
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
    )


def phase_main_path(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=5,
                    preset=FLAGSHIP, **overrides) -> dict:
    """One roundtrip through the public entry points, with the launch counts
    read around it; then ``iters`` timed roundtrips (on the card only)."""
    device = torch.device(device)
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    length = int(round(seconds * model.sample_rate))
    wav = torch.randn((batch, length), generator=torch.Generator().manual_seed(0)) * 0.1
    wav = wav.to(device)

    rvq_ops.LAUNCHES = 0
    lstm_ops.LAUNCHES = 0
    codes = model.encode(wav)
    out = model.decode(codes)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {"rvq_encode": rvq_ops.LAUNCHES, "lstm2": lstm_ops.LAUNCHES}

    on_card = device.type == "cuda"
    expected = {"rvq_encode": 1 if on_card else 0, "lstm2": 2 if on_card else 0}
    frames = math.ceil(length / model.hop_length)
    finite = bool(torch.isfinite(out.float()).all())
    print(f"[main] {preset} {dtype} on {device}: codes {tuple(codes.shape)}, wav {tuple(out.shape)}, "
          f"finite {finite}, launches {launches}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if tuple(codes.shape) != (model.n_q, batch, frames) or tuple(out.shape) != (batch, length):
        raise AssertionError(f"shapes: codes {tuple(codes.shape)}, wav {tuple(out.shape)}")
    if not finite:
        raise AssertionError("the decoded wav is not finite")
    result = {"launches": launches, "codes": codes, "wav": out, "model": model, "input": wav}
    if on_card and iters:
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: model.decode(model.encode(wav)), iters)
        result.update(
            roundtrip_ms=ms,
            realtime_factor=batch * seconds / (ms / 1e3),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        print(f"[main] roundtrip {ms:.3f} ms for {batch} x {seconds} s: "
              f"{result['realtime_factor']:.1f}x realtime, peak memory "
              f"{result['peak_mem_gib']:.3f} GiB ({nvidia_smi()})")
    return result


def phase_cross_check(device, seconds=0.3, batch=2) -> None:
    """The flagship-width f32 model on the card against the same seeded model
    on the CPU (plain versions) on a small input: tokens, and the wav decoded
    from the same tokens."""
    wav = torch.randn((batch, int(seconds * 24000)), generator=torch.Generator().manual_seed(2)) * 0.1
    gpu = load_codec(FLAGSHIP, device=device)
    cpu = load_codec(FLAGSHIP, device="cpu")
    codes_cpu = cpu.encode(wav)
    mismatch = (gpu.encode(wav).cpu() != codes_cpu).double().mean().item()
    err = (gpu.decode(codes_cpu).cpu() - cpu.decode(codes_cpu)).abs().max().item()
    print(f"[cross] f32 {FLAGSHIP} card vs CPU, {batch} x {seconds} s: token mismatch "
          f"{mismatch:.3g} (limit 1e-2), wav max abs diff {err:.3g} (atol 2e-4)")
    if not (mismatch <= 1e-2 and err <= 2e-4):
        raise AssertionError("the card's roundtrip disagrees with the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    k1 = phase_rvq(device)
    k2 = phase_lstm(device)
    main_path = phase_main_path(device)
    phase_cross_check(device)
    k1["launches"] = main_path["launches"]["rvq_encode"]
    k2["launches"] = main_path["launches"]["lstm2"]
    summary = {k: main_path[k] for k in ("roundtrip_ms", "realtime_factor", "peak_mem_gib")}
    print(f"[main] {json.dumps(summary)}")
    print(json.dumps({"kernels": [k1, k2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
