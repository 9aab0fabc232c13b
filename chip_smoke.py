#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Builds the hand-written kernels from ``academicodec_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card (K1 RVQ search, K2 LSTM,
K3 resblock tower, K4 GroupNorm resblock bundle and its two pass-2 kernels),
then drives the port's two
paths through the public entry points, each at batch 8 x 10 s in bf16 with
seeded random weights: the flagship Encodec_24k_240d roundtrip (wav ->
SEANet encoder -> RVQ -> SEANet decoder -> wav, N(0, 1) codebooks) and the
HiFi-Codec hificodec_24k_320d roundtrip (wav -> HiFi-GAN encoder -> GRVQ
tokens -> HiFi-GAN generator -> wav). Each path is followed by an f32
check of the card against the CPU. Any failed phase exits non-zero; without
a CUDA device it exits 1 at once.

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
import warnings

import torch

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.nn.hifigan import FUSED_MAX_CHANNELS
from academicodec_tpu_torch.nn.lstm import SLSTM
from academicodec_tpu_torch.ops.cuda import build as kernel_build
from academicodec_tpu_torch.ops.cuda import lstm as lstm_ops
from academicodec_tpu_torch.ops.cuda import resblock as resblock_ops
from academicodec_tpu_torch.ops.cuda import rvq as rvq_ops

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


def phase_main_path(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=5,
                    preset=FLAGSHIP, **overrides) -> dict:
    """One Encodec/SoundStream roundtrip through the public entry points,
    with the launch counts read around it; then ``iters`` timed roundtrips
    (on the card only)."""
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    length = int(round(seconds * model.sample_rate))
    wav = seeded_wav(batch, length, device)
    print(f"[main] {preset} {dtype} on {wav.device}")
    frames = math.ceil(length / model.hop_length)
    expected = {"rvq_encode": 1, "lstm2": 2, "resblock_tower": 0, "resblock_tower_gn": 0}
    result = checked_roundtrip("main", model, wav, expected, (model.n_q, batch, frames))
    if wav.device.type == "cuda" and iters:
        result.update(timed_roundtrips("main", model, wav, seconds, iters))
    return result


def phase_cross_check(device, preset=FLAGSHIP, seconds=0.3, batch=2) -> None:
    """A full-width f32 model on the card against the same seeded model on
    the CPU (plain versions) on a small input: tokens, and the wav decoded
    from the same tokens. HiFi-Codec codebooks are first spread over the CPU
    model's latent frames, identically on both."""
    wav = seeded_wav(batch, int(seconds * 24000), "cpu", seed=2)
    gpu = load_codec(preset, device=device)
    cpu = load_codec(preset, device="cpu")
    if preset == HIFI:
        frames = latent_frames(cpu, wav)
        spread_codebooks(gpu, frames)
        spread_codebooks(cpu, frames)
    codes_cpu = cpu.encode(wav)
    mismatch = (gpu.encode(wav).cpu() != codes_cpu).double().mean().item()
    err = (gpu.decode(codes_cpu).cpu() - cpu.decode(codes_cpu)).abs().max().item()
    print(f"[cross] f32 {preset} card vs CPU, {batch} x {seconds} s: token mismatch "
          f"{mismatch:.3g} (limit 1e-2), wav max abs diff {err:.3g} (atol 2e-4)")
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


def _tower_bound(B, C, T, ks, dss, itemsize, c_post=0, kp=0):
    """Bound of one tower call: its convs' operations at the bf16 peak, or
    the input, the output and the weights moved once."""
    taps = sum(k * len(resblock_ops.chain_conv_dilations(ds, "1")) for k, ds in zip(ks, dss))
    flops = 2.0 * B * T * C * C * taps + 2.0 * B * T * C * c_post * kp
    nbytes = itemsize * (B * C * T + B * (c_post or C) * T + C * C * taps + c_post * C * kp)
    return bound(flops, nbytes, PEAK_BF16_FLOPS)


def _geometry(packed, gn: bool) -> dict:
    """The tile geometry of a tower launch, as the wrapper picks it."""
    TT, H, _, buf, smem = resblock_ops.tower_geometry(packed, gn)
    geo = dict(TT=TT, W=TT + 2 * H, tensor_cores=packed.tc)
    if packed.tc:
        post = 0 if packed.wp is None else (packed.wp.shape[2] - 1) // 2
        g = resblock_ops.pick_tile_tc(packed.C, packed.kernel_sizes, packed.dilation_sizes,
                                      packed.resblock, post, gn)
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
    return dict(
        name="resblock_tower", route="cuda", source="academicodec_tpu_torch/csrc/resblock.cu",
        replaces="academicodec_tpu/ops/pallas/resblock.py:96",
        max_abs_err=max(c["max_abs_err"] for c in timed),
        tolerance="2e-2 x max|plain| in bf16, atol 1e-4 in f32",
        ms=sum(c["ms"] for c in timed), plain_ms=sum(c["plain_ms"] for c in timed),
        bound_ms=sum(c["bound_ms"] for c in timed), bound_by="operations", library_ms=None,
        note="ms, plain_ms and bound_ms sum the two launches of one decode (s2 + s3)", cases=cases,
    )


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
    return dict(
        name="resblock_tower_gn", route="cuda", source="academicodec_tpu_torch/csrc/resblock.cu",
        replaces="academicodec_tpu/ops/pallas/resblock.py:230", max_abs_err=timed["max_abs_err"],
        tolerance="atol 5e-2 in bf16, 1e-4 in f32; A, K rtol 1e-5; apply one ulp",
        ms=timed["ms"], plain_ms=timed["plain_ms"],
        bound_ms=timed["bound_ms"], bound_by=timed["bound_by"], library_ms=None,
        pass1_ms=timed["pass1_ms"], affine_ms=timed["affine_ms"], apply_ms=timed["apply_ms"],
        note="ms times the whole wrapper: the pass-1 kernel, the moments reduction, "
             "gn_affine_kernel and gn_apply_kernel", cases=cases,
    )


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
    """Redraw the GRVQ codebooks from a CPU generator so that tokens spread
    over them (the reference init, uniform +-1/1024, is far smaller than the
    latents): layer 0 entries are latent frames picked at random plus
    N(0, (0.1 s)^2) noise, layer 1 entries a quarter of the difference of two
    random frames; s is the frames' std. The same on every device."""
    q = model.quantizer
    g = torch.Generator().manual_seed(seed)
    n_res, G, K, gdim = q.codebooks.shape
    s = frames.std().item()

    def pick():
        return frames[torch.randint(frames.shape[0], (K,), generator=g)].reshape(K, G, gdim).transpose(0, 1)

    layers = [pick() + torch.randn((G, K, gdim), generator=g) * (0.1 * s)]
    layers += [(pick() - pick()) * 0.25 for _ in range(n_res - 1)]
    with torch.no_grad():
        q.codebooks.copy_(torch.stack(layers).to(q.codebooks))


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
    result["distinct_tokens"] = int(torch.unique(result["codes"]).numel())
    print(f"[hifi] {result['distinct_tokens']} distinct tokens")
    if wav.device.type == "cuda" and iters:
        result.update(timed_roundtrips("hifi", model, wav, seconds, iters))
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
    k3 = phase_resblock(device)
    k4 = phase_resblock_gn(device)
    main_path = phase_main_path(device)
    phase_cross_check(device)
    hifi = phase_hificodec(device)
    phase_cross_check(device, HIFI)
    k1["launches"] = main_path["launches"]["rvq_encode"]
    k2["launches"] = main_path["launches"]["lstm2"]
    k3["launches"] = hifi["launches"]["resblock_tower"]
    k4["launches"] = hifi["launches"]["resblock_tower_gn"]
    keys = ("roundtrip_ms", "realtime_factor", "peak_mem_gib")
    print(f"[main] {json.dumps({k: main_path[k] for k in keys})}")
    print(f"[hifi] {json.dumps({'distinct_tokens': hifi['distinct_tokens'], **{k: hifi[k] for k in keys}})}")
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
