#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Builds the hand-written kernels from ``academicodec_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card (K1 RVQ search, K2 LSTM,
K3 resblock tower with and without its convT prologue, K4 GroupNorm
resblock bundle with and without lengths, and its two pass-2 kernels),
then drives the port's
paths through the public entry points, each at batch 8 x 10 s in bf16 with
seeded random weights and codebooks spread over latent frames: the
flagship Encodec_24k_240d roundtrip (wav -> SEANet encoder -> RVQ -> SEANet
decoder -> wav) and the HiFi-Codec hificodec_24k_320d roundtrip (wav ->
HiFi-GAN encoder -> GRVQ tokens -> HiFi-GAN generator -> wav), the latter
also with the generator's upsampling fused into K3 (``hifi_pre``). Each
path is followed by an f32 check of the card against the CPU. Then the
serving paths of the codec layer: K2 continuing a stream from a carry
(``lstm2_carry``), streaming sessions of the causal Encodec_24k_240d (8
streams x 10 s in 100 ms chunks, wav -> tokens -> wav) and of the causal
hificodec_24k_320d generator (``stream``), ECDC file compression of 8
files x 10 s (``compress``), and HiFi-Codec corpus tokenization of 8 files
of 3-10 s through the ``extract_tokens`` CLI, batched with lengths and one
file a call (``extract``). Any failed phase exits non-zero; without a CUDA
device it exits 1 at once.

    python3 chip_smoke.py

Output ends with three lines: a JSON object of every kernel's numbers, the
card's name and power limit from nvidia-smi, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The phase functions take the device and the model's overrides as
arguments, so a CPU test can rehearse the main path at a tiny width. One
phase alone, on the card: ``python3 -c "import chip_smoke as c;
c.phase_device(); c.phase_build(); c.phase_stream('cuda')"``.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.codec import binary
from academicodec_tpu_torch.codec.compress import SoundStreamCompressor, decompress_codes
from academicodec_tpu_torch.native.build import get_bitpack_lib
from academicodec_tpu_torch.nn.hifigan import FUSED_MAX_CHANNELS
from academicodec_tpu_torch.nn.lstm import SLSTM
from academicodec_tpu_torch.ops.cuda import build as kernel_build
from academicodec_tpu_torch.ops.cuda import lstm as lstm_ops
from academicodec_tpu_torch.ops.cuda import resblock as resblock_ops
from academicodec_tpu_torch.ops.cuda import rvq as rvq_ops
from academicodec_tpu_torch.streaming import StreamingDecoder, StreamingEncoder, StreamingVQVAEDecoder

# NVIDIA H100 SXM data-sheet peaks (dense), at its full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

FLAGSHIP = "encodec_24k_240d"
HIFI = "hificodec_24k_320d"


def reset_launches() -> None:
    rvq_ops.LAUNCHES = 0
    lstm_ops.LAUNCHES = 0
    resblock_ops.TOWER_LAUNCHES = 0
    resblock_ops.GN_TOWER_LAUNCHES = 0


def read_launches() -> dict:
    return {
        "rvq_encode": rvq_ops.LAUNCHES, "lstm2": lstm_ops.LAUNCHES,
        "resblock_tower": resblock_ops.TOWER_LAUNCHES,
        "resblock_tower_gn": resblock_ops.GN_TOWER_LAUNCHES,
    }


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


def phase_rvq(device, n=8000, d=512, k=1024, n_q=12, ragged_n=75, stream_n=80, iters=10) -> dict:
    """K1 against its plain version at the flagship shape, at a ragged N and
    at a 100 ms streaming chunk's N; its time at the first and the last."""
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

    def rvq_bound(rows):
        return bound(2.0 * rows * k * d * n_q, 4.0 * (rows * d + n_q * k * d + n_q * rows), PEAK_F32_FLOPS)

    bound_ms, bound_by = rvq_bound(n)
    xs = x[-stream_n:].clone()
    mismatch_stream = (rvq_ops.rvq_encode(xs, embed) != rvq_ops.rvq_encode_plain(xs, embed)).double().mean().item()
    ms_stream = time_ms(lambda: rvq_ops.rvq_encode(xs, embed), iters)
    bound_stream, bound_stream_by = rvq_bound(stream_n)
    print(f"[rvq] [{n},{d}] x [{n_q},{k},{d}]: token mismatch {mismatch:.3g} (limit 1e-4), "
          f"ragged N={ragged_n}: {mismatch_ragged:.3g} (limit 0), N={stream_n}: {mismatch_stream:.3g} (limit 0)")
    print(f"[rvq] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"at N={stream_n} (a streaming chunk) {ms_stream:.4f} ms, bound {bound_stream:.4f} ms ({bound_stream_by})")
    if not (mismatch <= 1e-4 and mismatch_ragged == 0.0 and mismatch_stream == 0.0):
        raise AssertionError("rvq_encode disagrees with rvq_encode_plain")
    return dict(
        name="rvq_encode", route="cuda", source="academicodec_tpu_torch/csrc/rvq.cu",
        replaces="academicodec_tpu/ops/pallas/rvq.py:34", max_abs_err=float(max_abs_err),
        token_mismatch=mismatch, token_mismatch_stream_chunk=mismatch_stream,
        tolerance=f"token mismatch <= 1e-4 (0 at N={ragged_n} and N={stream_n})",
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        ms_stream_chunk=ms_stream, bound_ms_stream_chunk=bound_stream, stream_chunk_rows=stream_n,
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
        # the per-step floor: bare grid barriers on the same grid, no work
        barrier_us = time_ms(lambda: lstm_ops.grid_barriers(T, B, H, torch.bfloat16, device), iters) / T * 1e3
        # like with like for the cuDNN yardstick: the layer-1 input projection included
        ms_with_projection = time_ms(
            lambda: lstm_ops.lstm2(*mod.recurrence_inputs(x), out_dtype=torch.bfloat16), iters)
        plain_ms = time_ms(lambda: lstm_ops.lstm2_plain(*args, out_dtype=torch.bfloat16), 2)
        # yardstick only: cuDNN's 2-layer LSTM on the same weights and input
        # (it also computes the layer-1 input projection); the port never calls it
        ref_lstm = torch.nn.LSTM(H, H, num_layers=2).to(device=device, dtype=torch.bfloat16)
        ref_lstm.load_state_dict({k[len("lstm."):]: v for k, v in mod.state_dict().items()})
        ref_lstm.flatten_parameters()
        xt = x.permute(2, 0, 1).contiguous()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ref_lstm(xt)
            torch.cuda.synchronize()
        compacts = any("compacted" in str(w.message) or "contiguous chunk" in str(w.message) for w in caught)
        library_ms = time_ms(lambda: ref_lstm(xt), iters)
    nbytes = T * B * 4 * H * 4 + 3 * 4 * H * H * 2 + 4 * H * 4 + T * B * H * 2
    bound_ms, bound_by = bound(2.0 * 3 * 4 * H * H * B * T, nbytes, PEAK_BF16_FLOPS)
    jb, blocks, smem = lstm_ops.lstm2_geometry(B, H, 2, torch.cuda.get_device_properties(device).multi_processor_count)
    print(f"[lstm2] one launch of {blocks} blocks x {jb} units, {smem} B shared memory each")
    print(f"[lstm2] kernel {ms:.4f} ms ({ms / (T + 1) * 1e3:.2f} us per step; a bare grid barrier "
          f"{barrier_us:.2f} us), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    print(f"[lstm2] with the input projection {ms_with_projection:.4f} ms vs cuDNN LSTM {library_ms:.4f} ms "
          f"(cuDNN compacts its bf16 weights on every call: {'yes' if compacts else 'no'})")
    return dict(
        name="lstm2", route="cuda", source="academicodec_tpu_torch/csrc/lstm2.cu",
        replaces="academicodec_tpu/ops/pallas/lstm.py:36", max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32_ragged=errs[torch.float32],
        tolerance="atol/rtol 1e-2 in bf16, atol 1e-4 in f32",
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        us_per_step=ms / (T + 1) * 1e3, barrier_us=barrier_us, ms_with_projection=ms_with_projection,
        cudnn_compacts_weights=compacts, blocks=blocks, units_per_block=jb,
    )


def seeded_wav(batch: int, length: int, device, seed: int = 0) -> torch.Tensor:
    """Noise x0.1 from a CPU generator, the same on every device."""
    return (torch.randn((batch, length), generator=torch.Generator().manual_seed(seed)) * 0.1).to(device)


def checked_roundtrip(tag, model, wav, expected_launches, codes_shape):
    """One encode + decode through the public entry points with every launch
    count set to 0 just before and read just after; fails unless the counts,
    the shapes and the output's finiteness are as expected. On the CPU every
    expected count is 0 (the plain versions run)."""
    on_card = wav.device.type == "cuda"
    reset_launches()
    codes = model.encode(wav)
    out = model.decode(codes)
    if on_card:
        torch.cuda.synchronize()
    launches = read_launches()
    expected = {k: (n if on_card else 0) for k, n in expected_launches.items()}
    finite = bool(torch.isfinite(out.float()).all())
    print(f"[{tag}] {tuple(codes.shape)} codes, wav {tuple(out.shape)}, finite {finite}, launches {launches}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if tuple(codes.shape) != codes_shape or out.shape != wav.shape:
        raise AssertionError(f"shapes: codes {tuple(codes.shape)}, wav {tuple(out.shape)}")
    if not finite:
        raise AssertionError("the decoded wav is not finite")
    return {"launches": launches, "codes": codes, "wav": out, "model": model, "input": wav}


def timed_roundtrips(tag, model, wav, seconds, iters) -> dict:
    """Mean time of ``iters`` roundtrips by CUDA events, and their peak memory."""
    batch = wav.shape[0]
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: model.decode(model.encode(wav)), iters)
    result = dict(roundtrip_ms=ms, realtime_factor=batch * seconds / (ms / 1e3),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[{tag}] roundtrip {ms:.3f} ms for {batch} x {seconds} s: "
          f"{result['realtime_factor']:.1f}x realtime, peak memory "
          f"{result['peak_mem_gib']:.3f} GiB ({nvidia_smi()})")
    return result


# tokens that follow the latents spread over many codebook entries; a path
# that loses them collapses to one token a layer
MIN_DISTINCT_TOKENS = 8


def check_distinct(tag, codes) -> int:
    """The number of distinct tokens in ``codes``; fails at MIN_DISTINCT_TOKENS or fewer."""
    distinct = int(torch.unique(codes).numel())
    print(f"[{tag}] {distinct} distinct tokens (floor {MIN_DISTINCT_TOKENS})")
    if distinct <= MIN_DISTINCT_TOKENS:
        raise AssertionError(f"{tag}: {distinct} distinct tokens, the tokens do not follow the latents")
    return distinct


def phase_main_path(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=5,
                    preset=FLAGSHIP, **overrides) -> dict:
    """One Encodec/SoundStream roundtrip through the public entry points,
    with the launch counts read around it; then ``iters`` timed roundtrips
    (on the card only). The codebooks are first spread over the latent
    frames of two of the input rows (:func:`spread_codebooks`)."""
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    length = int(round(seconds * model.sample_rate))
    wav = seeded_wav(batch, length, device)
    spread_codebooks(model, latent_frames(model, wav[:2]))
    print(f"[main] {preset} {dtype} on {wav.device}, codebooks from latent frames")
    frames = math.ceil(length / model.hop_length)
    expected = {"rvq_encode": 1, "lstm2": 2, "resblock_tower": 0, "resblock_tower_gn": 0}
    result = checked_roundtrip("main", model, wav, expected, (model.n_q, batch, frames))
    result["distinct_tokens"] = check_distinct("main", result["codes"])
    if wav.device.type == "cuda" and iters:
        result.update(timed_roundtrips("main", model, wav, seconds, iters))
    return result


def phase_cross_check(device, preset=FLAGSHIP, seconds=0.3, batch=2, fused_pre=False) -> None:
    """A full-width f32 model on the card against the same seeded model on
    the CPU (plain versions) on a small input: tokens, and the wav decoded
    from the same tokens. The codebooks are first spread over the CPU model's
    latent frames, identically on both. ``fused_pre``: HiFi-Codec's generator
    with its upsampling fused into K3."""
    wav = seeded_wav(batch, int(seconds * 24000), "cpu", seed=2)
    gpu = load_codec(preset, device=device)
    cpu = load_codec(preset, device="cpu")
    if fused_pre:
        gpu.generator.fused_pre = cpu.generator.fused_pre = True
        print(f"[cross] {preset} with generator.fused_pre")
    frames = latent_frames(cpu, wav)
    spread_codebooks(gpu, frames)
    spread_codebooks(cpu, frames)
    codes_cpu = cpu.encode(wav)
    mismatch = (gpu.encode(wav).cpu() != codes_cpu).double().mean().item()
    err = (gpu.decode(codes_cpu).cpu() - cpu.decode(codes_cpu)).abs().max().item()
    print(f"[cross] f32 {preset} card vs CPU, {batch} x {seconds} s: token mismatch "
          f"{mismatch:.3g} (limit 1e-2), wav max abs diff {err:.3g} (atol 2e-4)")
    check_distinct("cross", codes_cpu)
    if not (mismatch <= 1e-2 and err <= 2e-4):
        raise AssertionError(f"the card's {preset} roundtrip disagrees with the CPU's")


RB1_KS, RB1_DS = (3, 7, 11), ((1, 3, 5),) * 3  # hificodec_24k_320d's ResBlock1 chains


def _tower_weights(C, ks, dss, device, dtype, seed, resblock="1"):
    """Seeded weights N(0, (0.5 / sqrt(C k))^2), so activations stay O(1)
    through the chains, and biases N(0, 0.1^2), as the wrappers take them."""
    g = torch.Generator().manual_seed(seed)
    weights, biases = [], []
    for k, ds in zip(ks, dss):
        n = len(resblock_ops.chain_conv_dilations(ds, resblock))
        weights.append([(torch.randn((C, C, k), generator=g) * (0.5 / math.sqrt(C * k))).to(device, dtype)
                        for _ in range(n)])
        biases.append([(torch.randn(C, generator=g) * 0.1).to(device, dtype) for _ in range(n)])
    return weights, biases


def _randn(shape, device, dtype, seed, scale=0.5):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def _tower_bound(B, C, T, ks, dss, itemsize, c_post=0, kp=0, c_in=0, k_pre=0, u=1):
    """Bound of one tower call: its convs' operations at the bf16 peak, or
    the input, the output and the weights moved once. With the prologue
    (``c_in`` channels, stride ``u``, ``k_pre`` taps) the input is ``[B, c_in,
    T / u]`` and each output sample of the convT takes ``k_pre / u`` taps."""
    taps = sum(k * len(resblock_ops.chain_conv_dilations(ds, "1")) for k, ds in zip(ks, dss))
    flops = 2.0 * B * T * C * C * taps + 2.0 * B * T * C * c_post * kp + 2.0 * B * T * C * c_in * k_pre / u
    x_elems = B * c_in * T // u if c_in else B * C * T
    nbytes = itemsize * (x_elems + B * (c_post or C) * T + C * C * taps + c_post * C * kp + c_in * C * k_pre)
    return bound(flops, nbytes, PEAK_BF16_FLOPS)


def _geometry(packed, gn: bool) -> dict:
    """The tile geometry of a tower launch, as the wrapper picks it."""
    TT, H, Hc, buf, smem = resblock_ops.tower_geometry(packed, gn)
    geo = dict(TT=TT, W=TT + 2 * H, tensor_cores=packed.tc)
    if packed.tc:
        g = resblock_ops.pick_tile_tc(packed.C, packed.kernel_sizes, packed.dilation_sizes,
                                      packed.resblock, H - Hc, gn, packed.pre_geo)
        geo.update(smem_bytes=smem, blocks_per_sm=g.blocks_per_sm, chain_starts=list(g.starts),
                   rows_multiplied_per_output_row=g.cost)
    return geo


def phase_resblock(device, iters=5) -> dict:
    """K3 against its plain version: bf16 at the generator's stage 2 (no post)
    and stage 3 (post + tanh) shapes, f32 at a ragged T below 2x the halo.
    Timed as the model calls it, with the operands packed once."""
    cases = []
    for tag, dtype, B, C, T, post in (
        ("s2", torch.bfloat16, 8, 64, 120000, False),
        ("s3", torch.bfloat16, 8, 32, 240000, True),
        ("f32 ragged", torch.float32, 3, 64, 101, True),
    ):
        weights, biases = _tower_weights(C, RB1_KS, RB1_DS, device, dtype, seed=C)
        kw = dict(kernel_sizes=RB1_KS, dilation_sizes=RB1_DS, resblock="1")
        pkw = {}
        if post:
            g = torch.Generator().manual_seed(7)
            pkw = dict(post_weight=(torch.randn((1, C, 7), generator=g) * (0.5 / math.sqrt(C * 7))).to(device, dtype),
                       post_bias=torch.zeros(1, device=device, dtype=dtype))
        x = _randn((B, C, T), device, dtype, seed=T)
        packed = resblock_ops.pack_tower(weights, biases, **kw, **pkw)
        with torch.no_grad():
            y = resblock_ops.resblock_tower(x, weights, biases, post_tanh=post, **kw, **pkw).float()
            y_packed = resblock_ops.resblock_tower(x, packed, post_tanh=post).float()
            ref = resblock_ops.resblock_tower_plain(x, weights, biases, post_tanh=post, **kw, **pkw).float()
        err = (y - ref).abs().max().item()
        # bf16: kernel and plain round at the same points; f32 summation order
        # can flip one bf16 rounding inside a chain, so the bound scales with |ref|
        tol = 2e-2 * ref.abs().max().item() if dtype == torch.bfloat16 else 1e-4
        geo = _geometry(packed, gn=False)
        print(f"[resblock] {tag} {dtype} [{B},{C},{T}] post={post}: max abs diff {err:.3g} (tol {tol:.3g}); {geo}")
        if not (y.shape == ref.shape and err <= tol and torch.equal(y, y_packed)):
            raise AssertionError(f"resblock_tower disagrees with resblock_tower_plain ({tag})")
        case = dict(case=tag, shape=[B, C, T], post=post, max_abs_err=err, tolerance=tol, geometry=geo)
        if dtype == torch.bfloat16:
            with torch.no_grad():
                case["ms"] = time_ms(lambda: resblock_ops.resblock_tower(x, packed, post_tanh=post), iters)
                case["ms_packing_each_call"] = time_ms(
                    lambda: resblock_ops.resblock_tower(x, weights, biases, post_tanh=post, **kw, **pkw), iters)
                case["plain_ms"] = time_ms(
                    lambda: resblock_ops.resblock_tower_plain(x, weights, biases, post_tanh=post, **kw, **pkw), 2)
            case["bound_ms"], case["bound_by"] = _tower_bound(B, C, T, RB1_KS, RB1_DS, 2, *((1, 7) if post else (0, 0)))
            case["share_of_bound"] = case["bound_ms"] / case["ms"]
            print(f"[resblock] {tag} kernel {case['ms']:.4f} ms ({case['ms_packing_each_call']:.4f} ms packing the "
                  f"weights at every call), plain {case['plain_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
                  f"({case['bound_by']}): {case['share_of_bound']:.1%} of the bound rate")
        cases.append(case)
        del x, y, y_packed, ref
    timed = [c for c in cases if "ms" in c]
    pre_cases = phase_resblock_pre(device, iters)
    pre_timed = [c for c in pre_cases if "ms" in c]
    return dict(
        name="resblock_tower", route="cuda", source="academicodec_tpu_torch/csrc/resblock.cu",
        replaces="academicodec_tpu/ops/pallas/resblock.py:96",
        max_abs_err=max(c["max_abs_err"] for c in timed + pre_timed),
        tolerance="2e-2 x max|plain| in bf16, atol 1e-4 in f32",
        ms=sum(c["ms"] for c in timed), plain_ms=sum(c["plain_ms"] for c in timed),
        bound_ms=sum(c["bound_ms"] for c in timed), bound_by="operations", library_ms=None,
        ms_fused_pre=sum(c["ms"] for c in pre_timed), plain_ms_fused_pre=sum(c["plain_ms"] for c in pre_timed),
        bound_ms_fused_pre=sum(c["bound_ms"] for c in pre_timed),
        convt_library_ms=sum(c["convt_library_ms"] for c in pre_timed),
        note="ms, plain_ms and bound_ms sum the two launches of one decode (s2 + s3); *_fused_pre the same "
             "two launches with the upsampling convT fused in (the prologue, pre_weight), and "
             "convt_library_ms the cuDNN conv_transpose1d + lrelu that the prologue replaces, at both stages",
        cases=cases + pre_cases,
    )


def phase_resblock_pre(device, iters=5) -> list:
    """K3 with its prologue (lrelu -> phase-major ConvTranspose1d, ``pre_weight``)
    against its plain version at the generator's stage 2 ([8,128,30000] ->
    [8,64,120000], k 8, stride 4) and stage 3 ([8,64,120000] -> [8,1,240000], k 4,
    stride 2, post conv + tanh) shapes, bf16 and f32; bf16 timed beside its
    bound, the same stage without the prologue, and cuDNN's conv_transpose1d
    + lrelu on the same input (the library yardstick of the prologue)."""
    cases = []
    for tag, dtype, B, C_in, C, T_in, u, kT, post in (
        ("s2 pre", torch.bfloat16, 8, 128, 64, 30000, 4, 8, False),
        ("s3 pre", torch.bfloat16, 8, 64, 32, 120000, 2, 4, True),
        ("s2 pre f32", torch.float32, 8, 128, 64, 30000, 4, 8, False),
        ("s3 pre f32", torch.float32, 8, 64, 32, 120000, 2, 4, True),
    ):
        weights, biases = _tower_weights(C, RB1_KS, RB1_DS, device, dtype, seed=C)
        g = torch.Generator().manual_seed(9)
        pkw = dict(pre_weight=(torch.randn((C_in, C, kT), generator=g) / math.sqrt(C_in * kT / u)).to(device, dtype),
                   pre_bias=(torch.randn(C, generator=g) * 0.1).to(device, dtype), pre_stride=u,
                   pre_pad=(kT - u) // 2)
        if post:
            pkw.update(post_weight=(torch.randn((1, C, 7), generator=g) * (0.5 / math.sqrt(C * 7))).to(device, dtype),
                       post_bias=torch.zeros(1, device=device, dtype=dtype))
        kw = dict(kernel_sizes=RB1_KS, dilation_sizes=RB1_DS, resblock="1")
        x = _randn((B, C_in, T_in), device, dtype, seed=T_in + 1)
        packed = resblock_ops.pack_tower(weights, biases, **kw, **pkw)
        with torch.no_grad():
            y = resblock_ops.resblock_tower(x, packed, post_tanh=post).float()
            ref = resblock_ops.resblock_tower_plain(x, weights, biases, post_tanh=post, **kw, **pkw).float()
        err = (y - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item() if dtype == torch.bfloat16 else 1e-4
        geo = _geometry(packed, gn=False)
        print(f"[resblock] {tag} {dtype} [{B},{C_in},{T_in}] -> [{B},{1 if post else C},{T_in * u}] post={post}: "
              f"max abs diff {err:.3g} (tol {tol:.3g}); {geo}")
        if not (y.shape == ref.shape and err <= tol):
            raise AssertionError(f"resblock_tower with its prologue disagrees with the plain version ({tag})")
        case = dict(case=tag, shape=[B, C_in, T_in], stride=u, post=post, max_abs_err=err, tolerance=tol,
                    geometry=geo)
        if dtype == torch.bfloat16:
            up = resblock_ops.convt_prologue_plain(x, pkw["pre_weight"], pkw["pre_bias"], u, (kT - u) // 2)
            post_kw = {k: v for k, v in pkw.items() if k.startswith("post")}
            unfused = resblock_ops.pack_tower(weights, biases, **kw, **post_kw)
            with torch.no_grad():
                case["ms"] = time_ms(lambda: resblock_ops.resblock_tower(x, packed, post_tanh=post), iters)
                case["ms_without_prologue"] = time_ms(
                    lambda: resblock_ops.resblock_tower(up, unfused, post_tanh=post), iters)
                case["convt_library_ms"] = time_ms(lambda: torch.nn.functional.conv_transpose1d(
                    torch.nn.functional.leaky_relu(x, 0.1), pkw["pre_weight"], pkw["pre_bias"], stride=u,
                    padding=(kT - u) // 2), iters)
                case["plain_ms"] = time_ms(
                    lambda: resblock_ops.resblock_tower_plain(x, weights, biases, post_tanh=post, **kw, **pkw), 2)
            case["bound_ms"], case["bound_by"] = _tower_bound(B, C, T_in * u, RB1_KS, RB1_DS, 2,
                                                              *((1, 7) if post else (0, 0)), C_in, kT, u)
            case["share_of_bound"] = case["bound_ms"] / case["ms"]
            print(f"[resblock] {tag} kernel {case['ms']:.4f} ms (without the prologue {case['ms_without_prologue']:.4f} "
                  f"ms, plus cuDNN convT + lrelu {case['convt_library_ms']:.4f} ms), plain {case['plain_ms']:.4f} ms, "
                  f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}): {case['share_of_bound']:.1%} of the bound rate")
            del up
        cases.append(case)
        del x, y, ref
    return cases


def _check_gn_pass2(outs, mom, scs, gbs, num_groups, T) -> dict:
    """``gn_affine_kernel`` and ``gn_apply_kernel`` against their plain versions
    on the same inputs: A, K within rtol 1e-5 (f32), the output within one
    ulp of its storage dtype."""
    A, K = resblock_ops.gn_affines_cuda(mom, scs, gbs, num_groups, 1e-6, T)
    A_ref, K_ref = resblock_ops.gn_affines(mom, scs, gbs, num_groups, 1e-6, T)
    y = resblock_ops.gn_apply_cuda(outs, A_ref, K_ref).float()
    y_ref = resblock_ops.gn_apply(list(outs), A_ref, K_ref).float()
    ulp = 2.0 ** -7 if outs.dtype == torch.bfloat16 else 2.0 ** -23  # relative size of one ulp at most
    errs = dict(
        affine_A_rel=((A - A_ref).abs() / A_ref.abs().clamp_min(1e-6)).max().item(),
        affine_K_rel=((K - K_ref).abs() / K_ref.abs().clamp_min(1e-3)).max().item(),
        apply_ulps=((y - y_ref).abs() / (y_ref.abs().clamp_min(1e-3) * ulp)).max().item(),
    )
    if not (errs["affine_A_rel"] <= 1e-5 and errs["affine_K_rel"] <= 1e-5 and errs["apply_ulps"] <= 1.0):
        raise AssertionError(f"K4 pass 2 kernels disagree with their plain versions: {errs}")
    return errs


def phase_resblock_gn(device, iters=5) -> dict:
    """K4 (pass 1 kernel, affines, apply) against its plain version: bf16 at
    the encoder's stage 0 shape with 3 chains, f32 at a ragged T; the two
    pass-2 kernels each against their own plain version; the moments and the
    output identical between two calls."""
    ks, dss = tuple(reversed(RB1_KS)), RB1_DS
    cases, timed = [], None
    for tag, dtype, B, C, T in (
        ("s0", torch.bfloat16, 8, 64, 120000),
        ("f32 ragged", torch.float32, 2, 32, 97),
    ):
        weights, biases = _tower_weights(C, ks, dss, device, dtype, seed=C + 1)
        g = torch.Generator().manual_seed(8)
        scs = (torch.randn((3, C), generator=g) * 0.3 + 1.0).to(device, dtype)
        gbs = (torch.randn((3, C), generator=g) * 0.1).to(device, dtype)
        kw = dict(kernel_sizes=ks, dilation_sizes=dss, resblock="1")
        gkw = dict(num_groups=C // 16)
        x = _randn((B, C, T), device, dtype, seed=T + 1)
        packed = resblock_ops.pack_tower(weights, biases, **kw)
        with torch.no_grad():
            y = resblock_ops.resblock_tower_gn(x, weights, biases, scs, gbs, **kw, **gkw)
            y_again = resblock_ops.resblock_tower_gn(x, packed, None, scs, gbs, **gkw)
            ref = resblock_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, **kw, **gkw).float()
            outs, mom = resblock_ops.gn_tower_chains(x, packed)
            _, mom_again = resblock_ops.gn_tower_chains(x, packed)
            pass2 = _check_gn_pass2(outs, mom, scs, gbs, C // 16, T)
        err = (y.float() - ref).abs().max().item()
        # the JAX package's bf16 tolerance for this bundle; f32: summation order only
        tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
        geo = _geometry(packed, gn=True)
        print(f"[resblock_gn] {tag} {dtype} [{B},{C},{T}]: max abs diff {err:.3g} (atol {tol}); pass 2 {pass2}; {geo}")
        if not (y.shape == ref.shape and err <= tol):
            raise AssertionError(f"resblock_tower_gn disagrees with resblock_tower_gn_plain ({tag})")
        if not (torch.equal(y, y_again) and torch.equal(mom, mom_again)):
            raise AssertionError(f"resblock_tower_gn differs between two calls ({tag})")
        case = dict(case=tag, shape=[B, C, T], max_abs_err=err, tolerance=tol, geometry=geo, **pass2)
        if dtype == torch.bfloat16:
            with torch.no_grad():
                A, K = resblock_ops.gn_affines_cuda(mom, scs, gbs, C // 16, 1e-6, T)
                case["ms"] = time_ms(lambda: resblock_ops.resblock_tower_gn(x, packed, None, scs, gbs, **gkw), iters)
                case["pass1_ms"] = time_ms(lambda: resblock_ops.gn_tower_chains(x, packed), iters)
                case["affine_ms"] = time_ms(
                    lambda: resblock_ops.gn_affines_cuda(mom, scs, gbs, C // 16, 1e-6, T), iters)
                case["apply_ms"] = time_ms(lambda: resblock_ops.gn_apply_cuda(outs, A, K), iters)
                case["plain_ms"] = time_ms(
                    lambda: resblock_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, **kw, **gkw), 2)
            case["bound_ms"], case["bound_by"] = _tower_bound(B, C, T, ks, dss, 2)
            case["share_of_bound"] = case["bound_ms"] / case["ms"]
            print(f"[resblock_gn] {tag} kernel {case['ms']:.4f} ms (pass 1 {case['pass1_ms']:.4f}, affines "
                  f"{case['affine_ms']:.4f}, apply {case['apply_ms']:.4f}), plain {case['plain_ms']:.4f} ms, "
                  f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}): {case['share_of_bound']:.1%} of the bound rate")
            timed = case
        cases.append(case)
        del x, y, y_again, ref, outs
    cases += phase_resblock_gn_lengths(device, iters)
    with_lengths = next(c for c in cases if "ms" in c and "lengths" in c)
    return dict(
        name="resblock_tower_gn", route="cuda", source="academicodec_tpu_torch/csrc/resblock.cu",
        replaces="academicodec_tpu/ops/pallas/resblock.py:230", max_abs_err=timed["max_abs_err"],
        tolerance="atol 5e-2 in bf16, 1e-4 in f32; A, K rtol 1e-5; apply one ulp; with lengths the same, "
                  "pad frames exactly 0",
        ms=timed["ms"], plain_ms=timed["plain_ms"],
        bound_ms=timed["bound_ms"], bound_by=timed["bound_by"], library_ms=None,
        pass1_ms=timed["pass1_ms"], affine_ms=timed["affine_ms"], apply_ms=timed["apply_ms"],
        ms_lengths=with_lengths["ms"], plain_ms_lengths=with_lengths["plain_ms"],
        bound_ms_lengths=with_lengths["bound_ms"],
        note="ms times the whole wrapper: the pass-1 kernel, the moments reduction, "
             "gn_affine_kernel and gn_apply_kernel; *_lengths the same with lengths spread over "
             "40000-120000 frames (the bound counts the valid frames' operations)", cases=cases,
    )


def phase_resblock_gn_lengths(device, iters=5, B=8, C=64, T=120000) -> list:
    """K4 with ``lengths`` at the encoder's stage 0 shape, the lengths spread
    over 40000-120000 frames and the input nonzero past them, bf16 and f32:
    against its plain version at K4's limits, pad frames exactly 0, and each
    row's valid frames against a call on that row alone at its exact length
    (0 difference expected: the same tiles in the same order, the pad adding
    exact zeros to the moments)."""
    ks, dss = tuple(reversed(RB1_KS)), RB1_DS
    L = torch.linspace(40000, T, B).round().to(torch.int32).to(device)
    lengths = L.tolist()
    cases = []
    for tag, dtype in (("s0 lengths", torch.bfloat16), ("s0 lengths f32", torch.float32)):
        weights, biases = _tower_weights(C, ks, dss, device, dtype, seed=C + 1)
        g = torch.Generator().manual_seed(8)
        scs = (torch.randn((3, C), generator=g) * 0.3 + 1.0).to(device, dtype)
        gbs = (torch.randn((3, C), generator=g) * 0.1).to(device, dtype)
        gkw = dict(num_groups=C // 16)
        x = _randn((B, C, T), device, dtype, seed=T + 2)
        packed = resblock_ops.pack_tower(weights, biases, kernel_sizes=ks, dilation_sizes=dss, resblock="1")
        with torch.no_grad():
            y = resblock_ops.resblock_tower_gn(x, packed, None, scs, gbs, lengths=L, **gkw)
            ref = resblock_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, kernel_sizes=ks,
                                                       dilation_sizes=dss, lengths=L, **gkw).float()
            err = (y.float() - ref).abs().max().item()
            pad_nonzero = sum(int(torch.count_nonzero(y[b, :, n:])) for b, n in enumerate(lengths))
            alone = max((y[b:b + 1, :, :n].float() - resblock_ops.resblock_tower_gn(
                x[b:b + 1, :, :n].contiguous(), packed, None, scs, gbs, **gkw).float()).abs().max().item()
                for b, n in enumerate(lengths))
        tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
        print(f"[resblock_gn] {tag} {dtype} [{B},{C},{T}] lengths {lengths}: max abs diff {err:.3g} (atol {tol}); "
              f"nonzero pad values {pad_nonzero} (limit 0); each row against its exact-length call: max abs "
              f"diff {alone:.3g} (atol {tol}, 0 expected)")
        if not (err <= tol and pad_nonzero == 0 and alone <= tol):
            raise AssertionError(f"resblock_tower_gn with lengths disagrees ({tag})")
        case = dict(case=tag, shape=[B, C, T], lengths=lengths, max_abs_err=err, tolerance=tol,
                    pad_nonzero=pad_nonzero, max_abs_diff_vs_exact_length=alone)
        if dtype == torch.bfloat16:
            with torch.no_grad():
                case["ms"] = time_ms(
                    lambda: resblock_ops.resblock_tower_gn(x, packed, None, scs, gbs, lengths=L, **gkw), iters)
                case["plain_ms"] = time_ms(lambda: resblock_ops.resblock_tower_gn_plain(
                    x, weights, biases, scs, gbs, kernel_sizes=ks, dilation_sizes=dss, lengths=L, **gkw), 2)
            taps = sum(k * len(resblock_ops.chain_conv_dilations(ds, "1")) for k, ds in zip(ks, dss))
            case["bound_ms"], case["bound_by"] = bound(2.0 * sum(lengths) * C * C * taps,
                                                       2 * (2 * B * C * T + C * C * taps), PEAK_BF16_FLOPS)
            print(f"[resblock_gn] {tag} kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, bound "
                  f"{case['bound_ms']:.4f} ms ({case['bound_by']})")
        cases.append(case)
        del x, y, ref
    return cases


def fused_stage_counts(config) -> dict:
    """K3/K4 launches one roundtrip makes on the card: one per generator stage
    and one per encoder stage no wider than FUSED_MAX_CHANNELS."""
    n = len(config.upsample_rates)
    gen = sum(config.upsample_initial_channel // 2 ** (i + 1) <= FUSED_MAX_CHANNELS for i in range(n))
    enc = sum(config.encoder_base_channels * 2 ** (i + 1) <= FUSED_MAX_CHANNELS for i in range(n))
    return {"resblock_tower": gen, "resblock_tower_gn": enc}


def latent_frames(model, wav) -> torch.Tensor:
    """The encoder's output frames for ``wav [B, T]`` as ``[B * frames, D]`` f32 on the CPU."""
    with torch.no_grad():
        c = model.encoder(wav[:, None, :].to(model.device, model.dtype))
    return c.transpose(1, 2).reshape(-1, c.shape[1]).float().cpu()


def spread_codebooks(model, frames: torch.Tensor, seed: int = 0) -> None:
    """Redraw the codebooks (HiFi-Codec's GRVQ, or Encodec's RVQ as one
    group) from a CPU generator so that tokens spread over them and follow
    the latents (the reference inits, uniform +-1/1024 and N(0, 1), are far
    from the random encoders' latents): layer 0 entries are latent frames
    picked at random plus N(0, (0.1 s)^2) noise, later layers' entries a
    quarter of the difference of two random frames; s is the frames' std.
    The same on every device."""
    q = model.quantizer
    book = q.codebooks if hasattr(q, "codebooks") else q.vq.embed[:, None]  # [layers, groups, K, dim]
    g = torch.Generator().manual_seed(seed)
    n_res, G, K, gdim = book.shape
    s = frames.std().item()

    def pick():
        return frames[torch.randint(frames.shape[0], (K,), generator=g)].reshape(K, G, gdim).transpose(0, 1)

    layers = [pick() + torch.randn((G, K, gdim), generator=g) * (0.1 * s)]
    layers += [(pick() - pick()) * 0.25 for _ in range(n_res - 1)]
    with torch.no_grad():
        book.copy_(torch.stack(layers).to(book))


def phase_hificodec(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=3,
                    preset=HIFI, **overrides) -> dict:
    """One HiFi-Codec roundtrip through the public entry points, with the
    launch counts read around it; then ``iters`` timed roundtrips (card only).
    The codebooks are first spread over the latent frames of two of the
    input rows (:func:`spread_codebooks`)."""
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    length = int(round(seconds * model.config.sampling_rate))
    wav = seeded_wav(batch, length, device)
    spread_codebooks(model, latent_frames(model, wav[:2]))
    print(f"[hifi] {preset} {dtype} on {wav.device}, codebooks from latent frames")
    frames = -(-length // model.hop_length)
    n_tok = model.quantizer.n_residual * model.quantizer.n_groups
    expected = {"rvq_encode": 0, "lstm2": 0, **fused_stage_counts(model.config)}
    result = checked_roundtrip("hifi", model, wav, expected, (batch, frames, n_tok))
    result["distinct_tokens"] = check_distinct("hifi", result["codes"])
    if wav.device.type == "cuda" and iters:
        result.update(timed_roundtrips("hifi", model, wav, seconds, iters))
    return result


def phase_hifi_pre(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=3,
                   preset=HIFI, **overrides) -> dict:
    """The HiFi-Codec roundtrip with ``generator.fused_pre = True`` (each fused
    stage's upsampling convT runs as K3's prologue), launch counts read
    around it, codebooks spread as in :func:`phase_hificodec`. The wav it
    decodes is held against the ``fused_pre=False`` decode of the same
    tokens: max abs diff / max |wav| <= 2e-2 (the two round the convT's
    output to bf16 after other summation orders). On the card both are
    timed, in turns."""
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    length = int(round(seconds * model.config.sampling_rate))
    wav = seeded_wav(batch, length, device)
    spread_codebooks(model, latent_frames(model, wav[:2]))
    with torch.no_grad():
        codes = model.encode(wav)
        unfused = model.decode(codes)
    model.generator.fused_pre = True
    print(f"[hifi_pre] {preset} {dtype} on {wav.device}, generator.fused_pre, codebooks from latent frames")
    frames = -(-length // model.hop_length)
    n_tok = model.quantizer.n_residual * model.quantizer.n_groups
    expected = {"rvq_encode": 0, "lstm2": 0, **fused_stage_counts(model.config)}
    result = checked_roundtrip("hifi_pre", model, wav, expected, (batch, frames, n_tok))
    result["distinct_tokens"] = check_distinct("hifi_pre", result["codes"])
    with torch.no_grad():
        err = _rel_err(model.decode(codes), unfused)
    result["wav_rel_err_vs_unfused"] = err
    print(f"[hifi_pre] decode with the prologue vs without, same tokens: max abs diff / max |wav| {err:.3g} "
          f"(limit 2e-2)")
    if not err <= 2e-2:
        raise AssertionError(f"hifi_pre: the fused_pre decode disagrees with the unfused one: {err:.3g}")
    if wav.device.type == "cuda" and iters:
        for fused in (False, True, True, False):
            model.generator.fused_pre = fused
            key = "fused_pre" if fused else "unfused"
            timed = timed_roundtrips(f"hifi_pre {key}", model, wav, seconds, iters)
            if key in result:  # the second of the turns: keep the mean of both
                timed = {k: (v + result[key][k]) / 2 for k, v in timed.items()}
            result[key] = timed
    return result


def phase_extract(device="cuda", n_files=8, min_seconds=3.0, max_seconds=10.0, bucket_seconds=10.0,
                  preset=HIFI, **overrides) -> dict:
    """Corpus tokenization through ``cli.extract_tokens.main``: ``n_files``
    seeded wavs of ``min_seconds``-``max_seconds`` and the seeded f32 model
    (codebooks spread over one file's latent frames) saved as a reference
    ``g_*`` file in a temporary directory; the CLI runs in-process,
    batched (``--batch_files n_files --bucket_seconds``, each row encoded
    with its length) with the launch counts read around it, then one file a
    call at exact lengths, both writing tokens and synthesized wavs. The two
    token sets must agree (mismatch <= 1e-3; 0 expected, JAX asserts
    bit-exactness). To locate a difference, a third run takes one file a
    call padded to whole buckets with its length (the batched run's shapes
    but batch 1), and the encoder's latents of one file padded with its
    length are held against its exact-length latents. On the card: audio
    seconds per wall second of the batched run."""
    import dataclasses
    import os
    import tempfile

    from academicodec_tpu_torch.cli import extract_tokens
    from academicodec_tpu_torch.data.wavio import write_wav

    model = load_codec(preset, device=device, **overrides)
    sr = model.config.sampling_rate
    rng = np.random.default_rng(11)
    lengths = rng.integers(int(min_seconds * sr), int(max_seconds * sr) + 1, n_files)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]
    spread_codebooks(model, latent_frames(model, torch.from_numpy(wavs[0][None])))
    on_card = model.device.type == "cuda"
    hop = model.hop_length
    bucket = math.ceil(round(bucket_seconds * sr) / hop) * hop
    w0 = torch.from_numpy(wavs[0])[None, None].to(model.device)
    with torch.no_grad():
        exact = model.encoder(w0)
        padded = model.encoder(torch.nn.functional.pad(w0, (0, -(-w0.shape[2] // bucket) * bucket - w0.shape[2])),
                               lengths=[w0.shape[2]])
    latent_diff = (padded[:, :, :exact.shape[2]] - exact).abs().max().item()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "wavs"))
        for i, w in enumerate(wavs):
            write_wav(os.path.join(tmp, "wavs", f"f{i}.wav"), w, sr)
        ckpt = os.path.join(tmp, "g_00000000")
        torch.save({part: getattr(model, part).state_dict() for part in ("encoder", "generator", "quantizer")},
                   ckpt)
        config = os.path.join(tmp, "config.json")
        with open(config, "w") as fh:
            json.dump(dataclasses.asdict(model.config), fh)
        del model
        flags = ["--config", config, "--model_path", ckpt, "--input", os.path.join(tmp, "wavs"),
                 "--device", str(device)]
        if on_card:
            torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        extract_tokens.main(flags + ["--outputdir", os.path.join(tmp, "out_b"), "--tokens_out",
                                     os.path.join(tmp, "b.npz"), "--batch_files", str(n_files),
                                     "--bucket_seconds", str(bucket_seconds)])
        if on_card:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        extract_tokens.main(flags + ["--outputdir", os.path.join(tmp, "out_s"), "--tokens_out",
                                     os.path.join(tmp, "s.npz"), "--batch_files", "1"])
        extract_tokens.main(flags + ["--outputdir", os.path.join(tmp, "out_p"), "--tokens_out",
                                     os.path.join(tmp, "p.npz"), "--no_synth", "--bucket_seconds", str(bucket_seconds)])
        batched, single, padded_single = (np.load(os.path.join(tmp, f"{t}.npz")) for t in "bsp")
        keys = sorted(batched.files)
        if not keys == sorted(single.files) == sorted(padded_single.files) or len(keys) != n_files:
            raise AssertionError(f"extract: token files {keys} and {sorted(single.files)}")
        shapes_ok = all(batched[k].shape == single[k].shape == padded_single[k].shape for k in keys)
        total = sum(batched[k].size for k in keys)

        def differ(a, b):
            return sum(int((a[k] != b[k]).sum()) for k in keys) if shapes_ok else total

        differ_b_s, differ_b_p, differ_p_s = differ(batched, single), differ(batched, padded_single), \
            differ(padded_single, single)
        distinct = check_distinct("extract", torch.from_numpy(np.concatenate([batched[k].reshape(-1) for k in keys])))
        synth = sorted(f for f in os.listdir(os.path.join(tmp, "out_b")) if f.endswith(".wav"))
    expected = {"rvq_encode": 0, "lstm2": 0, "resblock_tower": 2 if on_card else 0,
                "resblock_tower_gn": 1 if on_card else 0}
    mismatch = differ_b_s / total
    audio_s = float(lengths.sum()) / sr
    print(f"[extract] {n_files} files, {audio_s:.2f} s of audio: batched vs one file a call token mismatch "
          f"{mismatch:.3g} ({differ_b_s} of {total}; limit 1e-3, 0 expected), {len(synth)} wavs synthesized, "
          f"launches of the batched run {launches} (expected {expected})")
    print(f"[extract] to locate it: batched vs one padded file a call {differ_b_p} tokens differ, one padded "
          f"file a call vs exact lengths {differ_p_s}; latents of f0 padded with its length vs exact length: "
          f"max abs diff {latent_diff:.3g}")
    if not (shapes_ok and mismatch <= 1e-3 and len(synth) == n_files and launches == expected):
        raise AssertionError(f"extract: mismatch {mismatch:.3g}, shapes {shapes_ok}, {len(synth)} wavs, "
                             f"launches {launches}")
    result = {"launches": launches, "token_mismatch": mismatch, "distinct_tokens": distinct,
              "audio_seconds": audio_s, "tokens_differ_batched_vs_padded_single": differ_b_p,
              "tokens_differ_padded_single_vs_exact": differ_p_s, "latent_max_abs_diff_padded_vs_exact": latent_diff}
    if on_card:
        result.update(wall_s=wall_s, audio_seconds_per_wall_second=audio_s / wall_s)
        print(f"[extract] batched run {wall_s:.3f} s wall (model load, reads, encode, synthesis, writes): "
              f"{audio_s / wall_s:.1f} audio seconds per wall second ({nvidia_smi()})")
    return result


def phase_lstm2_carry(device, B=8, T=1000, H=512, ragged_t=70, iters=20) -> dict:
    """K2 continuing a stream. From a random carry, output and final state
    against the plain version's (bf16 at the flagship shape, f32 at a ragged
    T) at the lstm2 phase's tolerances; one call over T equal, bitwise, to
    calls over pieces of T that pass the carry along (100 x 10, 7 + 3 + 990,
    10 x 1), in bf16 and f32; the time of one call at T 10 (a streaming
    chunk) and T 1000."""
    slstm = SLSTM(H)
    slstm.lstm.reset_parameters(torch.Generator().manual_seed(1))
    g = torch.Generator(device=device).manual_seed(2)
    splits = {"100 x 10": (10,) * 100, "7 + 3 + 990": (7, 3, 990), "10 x 1": (1,) * 10}
    result = {}
    for dtype, steps, tol in ((torch.bfloat16, T, 1e-2), (torch.float32, ragged_t, 1e-4)):
        mod = copy.deepcopy(slstm).to(device=device, dtype=dtype)
        x = (torch.randn((B, H, T), generator=g, device=device) * 0.5).to(dtype)
        carry = tuple(torch.randn((B, H), generator=g, device=device) * 0.5 for _ in range(4))
        rtol = tol if dtype == torch.bfloat16 else 0.0
        with torch.no_grad():
            xp, *ws = mod.recurrence_inputs(x)

            def run(lo, hi, start):
                return lstm_ops.lstm2(xp[lo:hi], *ws, out_dtype=dtype, carry=start, return_carry=True)

            y, fin = run(0, steps, carry)
            ref, ref_fin = lstm_ops.lstm2_plain(xp[:steps], *ws, out_dtype=dtype, carry=carry, return_carry=True)
            pairs = [(y.float(), ref.float()), *zip(fin, ref_fin)]
            err = max((a - b).abs().max().item() for a, b in pairs)
            agree = all(torch.allclose(a, b, atol=tol, rtol=rtol) for a, b in pairs)
            bitwise = {}
            for name, split in splits.items():
                whole, whole_fin = run(0, sum(split), carry)
                ys, state, t = [], carry, 0
                for n in split:
                    piece, state = run(t, t + n, state)
                    ys.append(piece)
                    t += n
                bitwise[name] = torch.equal(torch.cat(ys), whole) and all(
                    torch.equal(a, b) for a, b in zip(state, whole_fin))
        print(f"[lstm2_carry] {dtype} [{B},{steps},{H}] from a random carry: max abs diff {err:.3g} "
              f"(atol {tol}, output and final state); split calls equal one call bitwise: {bitwise}")
        if not (agree and all(bitwise.values())):
            raise AssertionError(f"lstm2 with a carry disagrees ({dtype}): {err:.3g}, {bitwise}")
        key = "carry_max_abs_err" + ("" if dtype == torch.bfloat16 else "_f32_ragged")
        result[key] = err
        result["split_bitwise_" + ("bf16" if dtype == torch.bfloat16 else "f32")] = bitwise
        if dtype == torch.bfloat16:
            with torch.no_grad():
                result["ms_t10_carry"] = time_ms(lambda: run(0, 10, carry), iters)
                result["ms_t10_no_carry"] = time_ms(
                    lambda: lstm_ops.lstm2(xp[:10], *ws, out_dtype=dtype), iters)
                result["ms_t1000_carry"] = time_ms(lambda: run(0, T, carry), 5)
            n = 10
            nbytes = n * B * 4 * H * 4 + 3 * 4 * H * H * 2 + 4 * H * 4 + n * B * H * 2 + 2 * 4 * B * H * 4
            result["bound_ms_t10"], result["bound_by_t10"] = bound(
                2.0 * 3 * 4 * H * H * B * n, nbytes, PEAK_BF16_FLOPS)
            print(f"[lstm2_carry] bf16 per call: T 10 {result['ms_t10_carry']:.4f} ms with a carry "
                  f"({result['ms_t10_no_carry']:.4f} ms without; bound {result['bound_ms_t10']:.4f} ms, "
                  f"{result['bound_by_t10']}), T {T} {result['ms_t1000_carry']:.4f} ms with a carry")
    return result


def _timed_call(fn, arg, events):
    """``fn(arg)``; ``events`` (a list on the card, None on the CPU) gets the
    pair of CUDA events recorded around the call."""
    if events is None:
        return fn(arg)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(arg)
    end.record()
    events.append((start, end))
    return out


def _ms_stats(events) -> dict:
    ms = [a.elapsed_time(b) for a, b in events]
    return {"median": statistics.median(ms), "max": max(ms)}


def device_busy(fn):
    """Wall ms of ``fn`` (host clock, profiler on), the device's busy ms and
    operation count from torch.profiler (busy None when the profiler saw no
    device time), and the profiler for the tables of ``profile_port.py``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in ops) / 1e3
    return wall_ms, (busy_ms or None), len(ops), prof


def _profiled_window(result: dict, fn, chunks: int) -> str:
    """Profile ``fn`` (``chunks`` stream chunks) into ``result`` (the profiler
    under ``"profile"``); returns the summary for the log."""
    wall_ms, busy_ms, ops, prof = device_busy(fn)
    result.update(profile=prof, profiled_chunks=chunks, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                  device_ops_per_chunk=ops / chunks,
                  idle_share=None if busy_ms is None else max(0.0, 1 - busy_ms / wall_ms))
    busy = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms"
    return (f"profiled {chunks} chunks: wall {wall_ms:.3f} ms, device busy {busy}, "
            f"{ops / chunks:.0f} device operations per chunk ({nvidia_smi()})")


# Streaming against the full causal call in the path's own dtype (bf16 on the
# card): convs see other lengths, so cuDNN picks other algorithms, and the
# overlap-add tails are added after rounding; a flip in an early codebook
# cascades down the residual. Sound bf16 runs at 8 x 10 s on an H100 gave a
# token mismatch of 0.122 and wav errors of 0.0104 (Encodec) and 0.0083
# (HiFi-Codec); sessions that drop their state at every chunk (printed beside,
# as a control) gave 0.982, 0.807 and 0.367.
STREAM_TOKEN_MISMATCH_LIMIT = 0.25
STREAM_WAV_REL_ERR_LIMIT = 0.05


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| over max |ref|."""
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def _check_against_full(tag, result, pairs) -> str:
    """``pairs``: (name, streamed, stale, full, kind) with kind "tokens" or
    "wav"; records each comparison in ``result`` and fails past the limits."""
    parts = []
    for name, streamed, stale, full, kind in pairs:
        if kind == "tokens":
            err, ctl = ((x != full).double().mean().item() for x in (streamed, stale))
            limit, what = STREAM_TOKEN_MISMATCH_LIMIT, "token mismatch"
        else:
            err, ctl = _rel_err(streamed, full), _rel_err(stale, full)
            limit, what = STREAM_WAV_REL_ERR_LIMIT, "max abs diff / max |full|"
        result[f"{name}_vs_full"], result[f"{name}_vs_full_state_dropped"] = err, ctl
        parts.append(f"{name} {what} {err:.3g} (limit {limit}; state dropped at every chunk: {ctl:.3g})")
        if not err <= limit:
            raise AssertionError(f"{tag}: streamed {name} disagrees with the full causal call: {err:.3g}")
    return "; ".join(parts)


def phase_stream(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, chunk_seconds=0.1,
                 warm_chunks=3, profile_chunks=10, preset=FLAGSHIP, **overrides) -> dict:
    """The streaming path: ``batch`` streams of ``seconds`` of a causal,
    zero-padded Encodec fed in chunks of ``chunk_seconds`` through
    ``StreamingEncoder`` to tokens and each chunk's tokens through
    ``StreamingDecoder`` back to wav, with the launch counts read around the
    whole stream; the codebooks are first spread over the latent frames of
    two streams (:func:`spread_codebooks`), so that tokens follow the
    latents. The streamed tokens are held against ``model.encode`` of
    the whole wav and the streamed wav against ``model.decode`` of the
    streamed tokens, in the same dtype (:func:`_check_against_full`). On the
    card: each chunk's encode and decode ms by CUDA events, the realtime
    factor (audio seconds over wall seconds), peak memory, and the device's
    busy share of ``profile_chunks`` chunks."""
    model = load_codec(preset, device=device, dtype=dtype, causal=True, pad_mode="zero", **overrides)
    hop = model.hop_length
    chunk = int(round(chunk_seconds * model.sample_rate)) // hop * hop
    n_chunks = int(round(seconds * model.sample_rate)) // chunk
    wav = seeded_wav(batch, n_chunks * chunk, device, seed=5)
    spread_codebooks(model, latent_frames(model, wav[:2]))
    chunks = wav.split(chunk, dim=-1)
    on_card = wav.device.type == "cuda"
    print(f"[stream] {preset} causal {dtype} on {wav.device}: {batch} streams x {n_chunks} chunks of {chunk} "
          f"samples, codebooks from latent frames")
    enc, dec = StreamingEncoder(model), StreamingDecoder(model)
    for c in chunks[:warm_chunks]:  # cuDNN picks its algorithms on a session of its own
        dec.process(enc.process(c))
    enc, dec = StreamingEncoder(model), StreamingDecoder(model)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    codes, outs = [], []
    enc_ev, dec_ev = ([], []) if on_card else (None, None)
    for c in chunks:
        codes.append(_timed_call(enc.process, c, enc_ev))
        outs.append(_timed_call(dec.process, codes[-1], dec_ev))
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    codes, out = torch.cat(codes, -1), torch.cat(outs, -1)
    expected = {"rvq_encode": n_chunks, "lstm2": 2 * n_chunks, "resblock_tower": 0, "resblock_tower_gn": 0}
    expected = {k: (n if on_card else 0) for k, n in expected.items()}
    finite = bool(torch.isfinite(out.float()).all())
    print(f"[stream] codes {tuple(codes.shape)}, wav {tuple(out.shape)}, finite {finite}, launches {launches}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if tuple(codes.shape) != (model.n_q, batch, n_chunks * chunk // hop) or out.shape != wav.shape or not finite:
        raise AssertionError(f"streaming output: codes {tuple(codes.shape)}, wav {tuple(out.shape)}, finite {finite}")
    result = {"launches": launches, "chunks": n_chunks, "chunk_samples": chunk,
              "launches_per_chunk": {k: v / n_chunks for k, v in launches.items()},
              "distinct_tokens": int(torch.unique(codes).numel())}
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    stale_codes = torch.cat([StreamingEncoder(model).process(c) for c in chunks], -1)
    stale_wav = torch.cat([StreamingDecoder(model).process(k) for k in codes.split(chunk // hop, -1)], -1)
    agreement = _check_against_full("stream", result, (
        ("tokens", codes, stale_codes, model.encode(wav), "tokens"),
        ("wav", out, stale_wav, model.decode(codes), "wav")))
    print(f"[stream] {dtype} streaming vs the full causal call ({result['distinct_tokens']} distinct tokens): "
          f"{agreement}")
    if not on_card:
        return result
    result.update(
        encode_ms_per_chunk=_ms_stats(enc_ev), decode_ms_per_chunk=_ms_stats(dec_ev), wall_s=wall_s,
        realtime_factor=batch * n_chunks * chunk / model.sample_rate / wall_s,
        peak_mem_gib=peak_mem_gib,
    )
    enc, dec = StreamingEncoder(model), StreamingDecoder(model)
    window = _profiled_window(result, lambda: [dec.process(enc.process(c)) for c in chunks[:profile_chunks]],
                              profile_chunks)
    print(f"[stream] encode ms per chunk {result['encode_ms_per_chunk']}, decode {result['decode_ms_per_chunk']}; "
          f"{result['realtime_factor']:.1f}x realtime ({wall_s:.3f} s for {batch} x {seconds} s); "
          f"K1 {result['launches_per_chunk']['rvq_encode']:g} and K2 {result['launches_per_chunk']['lstm2']:g} "
          f"launches per chunk; peak memory {result['peak_mem_gib']:.3f} GiB; {window}")
    return result


def phase_stream_hifi(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, chunk_frames=10,
                      warm_chunks=3, profile_chunks=10, preset=HIFI, **overrides) -> dict:
    """The causal HiFi-Codec generator streaming ``batch`` streams of seeded
    random tokens through ``StreamingVQVAEDecoder`` in chunks of
    ``chunk_frames`` frames; no K3 on causal stages. The streamed wav is held
    against ``model.decode`` of all the tokens, in the same dtype. Card
    numbers as in :func:`phase_stream`."""
    model = load_codec(preset, device=device, dtype=dtype, causal=True, **overrides)
    sr, hop = model.config.sampling_rate, model.hop_length
    n_chunks = int(round(seconds * sr)) // hop // chunk_frames
    n_tok = model.quantizer.n_residual * model.quantizer.n_groups
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, model.config.n_codes, size=(batch, n_chunks * chunk_frames, n_tok)).astype(np.int32))
    chunks = toks.to(model.device).split(chunk_frames, dim=1)
    on_card = model.device.type == "cuda"
    dec = StreamingVQVAEDecoder(model)
    for c in chunks[:warm_chunks]:
        dec.process(c)
    dec = StreamingVQVAEDecoder(model)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    dec_ev = [] if on_card else None
    outs = [_timed_call(dec.process, c, dec_ev) for c in chunks]
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    out = torch.cat(outs, -1)
    finite = bool(torch.isfinite(out.float()).all())
    print(f"[stream_hifi] {preset} causal {dtype}: {batch} x {n_chunks} chunks of {chunk_frames} frames, "
          f"wav {tuple(out.shape)}, finite {finite}, launches {launches}")
    if any(launches.values()) or out.shape != (batch, n_chunks * chunk_frames * hop) or not finite:
        raise AssertionError(f"streaming HiFi-Codec decode: launches {launches}, wav {tuple(out.shape)}")
    result = {"launches": launches, "chunks": n_chunks, "chunk_frames": chunk_frames}
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    stale = torch.cat([StreamingVQVAEDecoder(model).process(c) for c in chunks], -1)
    agreement = _check_against_full("stream_hifi", result, (
        ("wav", out, stale, model.decode(torch.cat(chunks, 1)), "wav"),))
    print(f"[stream_hifi] {dtype} streaming vs the full causal decode: {agreement}")
    if not on_card:
        return result
    result.update(decode_ms_per_chunk=_ms_stats(dec_ev), wall_s=wall_s,
                  realtime_factor=batch * n_chunks * chunk_frames * hop / sr / wall_s,
                  peak_mem_gib=peak_mem_gib)
    dec = StreamingVQVAEDecoder(model)
    window = _profiled_window(result, lambda: [dec.process(c) for c in chunks[:profile_chunks]], profile_chunks)
    print(f"[stream_hifi] decode ms per chunk {result['decode_ms_per_chunk']}; {result['realtime_factor']:.1f}x "
          f"realtime ({wall_s:.3f} s); peak memory {result['peak_mem_gib']:.3f} GiB; {window}")
    return result


def phase_stream_check(device, seconds=1.0, batch=2) -> dict:
    """Streaming against the full causal call on the same card, f32 with TF32
    off, full width: Encodec tokens with codebooks spread over the latents
    (mismatch <= 2%, JAX's bound for
    shape-dependent near-tie flips, tests/test_streaming.py), Encodec wav
    decoded chunk by chunk from the full encode's tokens (atol 1e-4), and the
    HiFi-Codec generator's streaming decode of seeded tokens (atol 1e-4)."""
    model = load_codec(FLAGSHIP, device=device, causal=True, pad_mode="zero")
    chunk = model.hop_length * 10
    wav = seeded_wav(batch, int(seconds * model.sample_rate) // chunk * chunk, device, seed=3)
    spread_codebooks(model, latent_frames(model, wav))
    full = model.encode(wav)
    enc, dec = StreamingEncoder(model), StreamingDecoder(model)
    streamed = torch.cat([enc.process(c) for c in wav.split(chunk, -1)], -1)
    mismatch = (streamed != full).double().mean().item()
    wav_err = (torch.cat([dec.process(c) for c in full.split(10, -1)], -1) - model.decode(full)).abs().max().item()
    hifi = load_codec(HIFI, device=device, causal=True)
    frames = int(seconds * hifi.config.sampling_rate) // hifi.hop_length
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, hifi.config.n_codes, size=(batch, frames, 4)).astype(np.int32))
    hdec = StreamingVQVAEDecoder(hifi)
    hifi_err = (torch.cat([hdec.process(c) for c in toks.split(10, 1)], -1) - hifi.decode(toks)).abs().max().item()
    distinct = int(torch.unique(full).numel())
    print(f"[stream_check] f32, {batch} x {seconds} s: Encodec streaming vs full tokens ({distinct} distinct) mismatch {mismatch:.3g} "
          f"(limit 0.02), wav max abs diff {wav_err:.3g} (atol 1e-4); HiFi-Codec streaming vs full decode "
          f"{hifi_err:.3g} (atol 1e-4)")
    if not (mismatch <= 0.02 and wav_err <= 1e-4 and hifi_err <= 1e-4):
        raise AssertionError("streaming disagrees with the full causal call")
    return {"token_mismatch": mismatch, "distinct_tokens": distinct, "wav_max_abs_err": wav_err,
            "hifi_wav_max_abs_err": hifi_err}


def phase_compress(device="cuda", dtype=torch.bfloat16, n_files=8, seconds=10.0, bucket_seconds=10.0,
                   iters=3, preset=FLAGSHIP, **overrides) -> dict:
    """ECDC compression of ``n_files`` files of ``seconds`` through
    ``SoundStreamCompressor.compress_batch`` and back through
    ``decompress_batch``, with the launch counts read around it; the
    codebooks are first spread over two files' latent frames. Each blob
    must unpack to exactly the tokens ``model.encode`` gives for the batch,
    and ``decompress_batch`` must equal ``model.decode`` of those tokens,
    trimmed, bitwise. On the card: both calls' ms by the host clock (each
    ends in a copy to the host), beside the plain roundtrip of the same
    batch from a device tensor."""
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    batch = seeded_wav(n_files, int(round(seconds * model.sample_rate)), "cpu", seed=4)
    wavs = [row.numpy() for row in batch]
    spread_codebooks(model, latent_frames(model, batch[:2]))
    comp = SoundStreamCompressor(model, bucket_seconds=bucket_seconds)
    on_card = model.device.type == "cuda"
    comp.decompress_batch(comp.compress_batch(wavs))  # warm-up
    if on_card:
        torch.cuda.synchronize()
    reset_launches()
    blobs = comp.compress_batch(wavs)
    out = comp.decompress_batch(blobs)
    if on_card:
        torch.cuda.synchronize()
    launches = read_launches()
    expected = {"rvq_encode": 1, "lstm2": 2, "resblock_tower": 0, "resblock_tower_gn": 0}
    expected = {k: (n if on_card else 0) for k, n in expected.items()}
    codes = model.encode(batch)
    ref = model.decode(codes).float().cpu().numpy()
    codes = codes.cpu().numpy()
    tokens_exact = all(np.array_equal(decompress_codes(b)[0], codes[:, i, : -(-len(w) // model.hop_length)])
                       for i, (b, w) in enumerate(zip(blobs, wavs)))
    wav_exact = all(np.array_equal(o, ref[i, : len(w)]) and sr == model.sample_rate
                    for i, ((o, sr), w) in enumerate(zip(out, wavs)))
    sizes = [len(b) for b in blobs]
    distinct = len(np.unique(codes))
    print(f"[compress] {preset} {dtype}, {n_files} files x {seconds} s, codebooks from latent frames: launches "
          f"{launches}, blob bytes {sizes}, {distinct} distinct tokens, tokens exact {tokens_exact}, wav equal to "
          f"model.decode bitwise {wav_exact}")
    if launches != expected or not (tokens_exact and wav_exact):
        raise AssertionError(f"compression path: launches {launches} (expected {expected}), tokens "
                             f"{tokens_exact}, wav {wav_exact}")
    result = {"launches": launches, "blob_bytes": sizes, "distinct_tokens": distinct}
    if not on_card:
        return result

    def host_ms(fn):
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.mean(times)

    x = batch.to(device)
    codes_dev = comp.submit_encode(wavs)
    result.update(
        compress_batch_ms=host_ms(lambda: comp.compress_batch(wavs)),
        decompress_batch_ms=host_ms(lambda: comp.decompress_batch(blobs)),
        roundtrip_ms=host_ms(lambda: model.decode(model.encode(x))),
        # the parts: the encode from the host's wavs, the packing from device codes,
        # and the plain encode and decode of a device tensor
        submit_encode_ms=host_ms(lambda: comp.submit_encode(wavs)),
        pack_ms=host_ms(lambda: comp.pack_submitted(codes_dev, [len(w) for w in wavs])),
        encode_ms=host_ms(lambda: model.encode(x)),
        decode_ms=host_ms(lambda: model.decode(codes_dev)),
        native_packer=get_bitpack_lib() is not None,
    )
    # the host bit packers on the 8 files' tokens: native (when it builds) and numpy
    files = [np.ascontiguousarray(codes[:, i]) for i in range(n_files)]
    bits = model.bits_per_codebook
    for name, pack, unpack in (("native", binary.pack_array, binary.unpack_array),
                               ("numpy", binary.pack_array_numpy, binary.unpack_array_numpy)):
        if name == "native" and not result["native_packer"]:
            continue
        packed = [pack(f, bits) for f in files]
        result[f"pack_{name}_ms"] = host_ms(lambda: [pack(f, bits) for f in files])
        result[f"unpack_{name}_ms"] = host_ms(lambda: [unpack(b, bits, f.size) for b, f in zip(packed, files)])
    print(f"[compress] compress_batch {result['compress_batch_ms']:.3f} ms (submit_encode "
          f"{result['submit_encode_ms']:.3f}, pack_submitted {result['pack_ms']:.3f}, native packer "
          f"{result['native_packer']}; packing {n_files} files' tokens: native {result.get('pack_native_ms')} ms, "
          f"numpy {result['pack_numpy_ms']:.3f} ms; unpacking: native {result.get('unpack_native_ms')} ms, "
          f"numpy {result['unpack_numpy_ms']:.3f} ms), decompress_batch {result['decompress_batch_ms']:.3f} ms; plain "
          f"roundtrip {result['roundtrip_ms']:.3f} ms (encode {result['encode_ms']:.3f}, decode "
          f"{result['decode_ms']:.3f}) (host clock, mean of {iters}; {nvidia_smi()})")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    k1 = phase_rvq(device)
    k2 = phase_lstm(device)
    k2.update(phase_lstm2_carry(device))
    k3 = phase_resblock(device)
    k4 = phase_resblock_gn(device)
    main_path = phase_main_path(device)
    phase_cross_check(device)
    hifi = phase_hificodec(device)
    phase_cross_check(device, HIFI)
    hifi_pre = phase_hifi_pre(device)
    phase_cross_check(device, HIFI, fused_pre=True)
    stream = phase_stream(device)
    stream_hifi = phase_stream_hifi(device)
    stream_check = phase_stream_check(device)
    compress = phase_compress(device)
    extract = phase_extract(device)
    k1["launches"] = main_path["launches"]["rvq_encode"]
    k2["launches"] = main_path["launches"]["lstm2"]
    for k, name in ((k1, "rvq_encode"), (k2, "lstm2")):
        k["launches_per_stream_chunk"] = stream["launches_per_chunk"][name]
        k["launches_compress_roundtrip"] = compress["launches"][name]
    k3["launches"] = hifi["launches"]["resblock_tower"]
    k3["launches_fused_pre"] = hifi_pre["launches"]["resblock_tower"]
    k3["launches_extract"] = extract["launches"]["resblock_tower"]
    k4["launches"] = hifi["launches"]["resblock_tower_gn"]
    k4["launches_extract"] = extract["launches"]["resblock_tower_gn"]
    keys = ("roundtrip_ms", "realtime_factor", "peak_mem_gib")
    print(f"[main] {json.dumps({'distinct_tokens': main_path['distinct_tokens'], **{k: main_path[k] for k in keys}})}")
    print(f"[hifi] {json.dumps({'distinct_tokens': hifi['distinct_tokens'], **{k: hifi[k] for k in keys}})}")
    print(f"[hifi_pre] {json.dumps({k: hifi_pre[k] for k in ('distinct_tokens', 'wav_rel_err_vs_unfused', 'unfused', 'fused_pre')})}")
    print(f"[extract] {json.dumps(extract)}")
    skip = ("launches", "profile")
    print(f"[stream] {json.dumps({k: v for k, v in stream.items() if k not in skip})}")
    print(f"[stream_hifi] {json.dumps({k: v for k, v in stream_hifi.items() if k not in skip})}")
    print(f"[stream_check] {json.dumps(stream_check)}")
    print(f"[compress] {json.dumps(compress)}")
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
