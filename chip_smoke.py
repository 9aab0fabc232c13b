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
Snake epilogue kernel (``csrc/snake.cu``) on the DAC 44.1 kHz main path at
16 x 10 s in bf16 (``snake``): its 58 launches a roundtrip, every call held
against its plain version in bf16, f16 and f32, its time against the eager
aten chain and its bound, and the roundtrip with and without its zero
frames past ``T``. Then the
serving paths of the codec layer: K2 continuing a stream from a carry
(``lstm2_carry``), streaming sessions of the causal Encodec_24k_240d (8
streams x 10 s in 100 ms chunks, wav -> tokens -> wav) and of the causal
hificodec_24k_320d generator (``stream``), ECDC file compression of 8
files x 10 s (``compress``), and HiFi-Codec corpus tokenization of 8 files
of 3-10 s through the ``extract_tokens`` CLI, batched with lengths and one
file a call (``extract``; and once more batched with W8A8 int8 serving and
LM-coded token blobs). Then the serving options: LM entropy coding of one
10 s flagship file with a token LM at ``cli/train_lm.py``'s default width
(``lm``), W8A8 int8 HiFi-Codec serving of 8 x 10 s against bf16 (``int8``),
and the SEANet layer options ``time_group_norm``, ``layer_norm`` and a
3-layer SLSTM at the flagship's widths, streamed too (``layer_opts``).
Last, training (``train``): the Encodec/SoundStream GAN trainer at
Encodec_24k_240d's full width with the reference discriminators, 16 x 1 s,
f32 and bf16 mixed precision, with K1 in the quantizer's search and k-means
and K2 in the no-grad regenerate, each also held against its plain version
at the trainer's shapes; one reduced-width step on the card
against the CPU; and ``cli.train_encodec`` for 2 epochs, resumed for a third,
whose checkpoint ``cli.compress`` then serves. The HiFi-Codec GAN trainer
(``train_hifi``) at hificodec_24k_320d's full width with the reference
discriminators, 10 x 16000 samples, f32 and mixed precision, with K4 and
K3 x2 in the D phase's no-grad generator forward and none in the G phase
(its stages run unfused under autograd), K3/K4 held against their plain
versions at the trainer's shapes, one reduced-width step on the card
against the CPU with two fault controls, and ``cli.train_hificodec`` whose
state ``cli.extract_tokens`` serves; the token-LM trainer (``train_lm``) at
``cli/train_lm.py``'s default width on Encodec_24k_240d's 12 kbps tokens
(K1 + K2 in the tokenizer), and ``cli.train_lm`` whose LM ``cli.compress
--lm`` takes. Then objective evaluation (``evaluate``): 8 speech-like files
of 3-10 s through ``cli.compress`` (Encodec_24k_240d, K1 + K2) and
``cli.extract_tokens`` (hificodec_24k_320d, K3 + K4), each output scored by
``cli.evaluate`` (SI-SNR, the mel distance on the card, STOI/ESTOI, PESQ
nb/wb); and the C++ crop loader (``native_loader``): built, an epoch
bit-identical to the Python pipeline, batches a second against it, and
``cli.train_encodec`` / ``cli.train_hificodec`` at full width fed by it
against the Python-fed runs. Then data parallelism (``parallel``) and
time-sharded serving (``sequence``): one 60 s Encodec_24k_240d stream in f32
and bf16 through ``TimeShardedSoundStream`` on 1 and 4 time shards of the
card against the unsharded model, one 60 s hificodec_24k_320d file through
``cli.extract_tokens --sequence_parallel --device cuda:0,cuda:0,cuda:0,cuda:0``
against the CLI without it, and ``cli.compress --sequence_parallel`` on
three files (K1-K4 on every shard; K4's per-tile GroupNorm moments of every
shard reduced in the sequence's tile order, its passes held against their
plain versions and the sharded stage bit for bit against one launch). Last,
the int8 decision probe (``probe_chain``, ``probes/int8_chain.py``): the two
conv chains of ``benchmarks/pallas_int8_probe.py``, P1 (bf16) and P2 (W8A8),
at the probe's four tiles and at K3's stage shapes s2 [8, 64, 120000] and s3
[8, 32, 240000], each held against its plain version (P1 within 2e-2 of max
|plain|, P2 bit for bit, P2 within 0.12 relative L2 of the f32 reference),
and the probe's decision taken from the s2/s3 ratios; P1/P2 launch on no
other phase. Any failed phase exits non-zero; without a CUDA device it
exits 1 at once.

    python3 chip_smoke.py

Output ends with three lines: a JSON object of every kernel's numbers, the
card's name and power limit from nvidia-smi, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The phase functions take the device and the model's overrides as
arguments, so a CPU test can rehearse the main path at a tiny width. One
phase alone, on the card: ``python3 -c "import chip_smoke as c;
c.phase_device(); c.phase_build(); c.phase_stream('cuda')"``. Opt-in, not in
the run: ``phase_extract_stages`` (where batched and one-file-a-call
extraction part, every encoder stage held against the exact-length encode)
and ``phase_extract_groupnorm`` (what f64 GroupNorm statistics cost corpus
tokenization).
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from academicodec_tpu_torch.api import load_codec
from academicodec_tpu_torch.codec import binary
from academicodec_tpu_torch.codec.compress import (
    SoundStreamCompressor,
    compress_codes,
    compress_tokens_guarded,
    decompress_codes,
    decompress_tokens,
)
from academicodec_tpu_torch.codec.lm_compress import compress_tokens_with_lm, decompress_tokens_with_lm, make_step
from academicodec_tpu_torch.models.hificodec import calibrate_quant
from academicodec_tpu_torch.models.lm import RVQTokenLM, save_lm
from academicodec_tpu_torch.native.build import get_bitpack_lib
from academicodec_tpu_torch.nn import dac as dac_nn
from academicodec_tpu_torch.nn.hifigan import FUSED_MAX_CHANNELS, Segments, stage_reach, strided_length
from academicodec_tpu_torch.nn.lstm import SLSTM
from academicodec_tpu_torch.ops import int8 as int8_ops
from academicodec_tpu_torch.ops.cuda import build as kernel_build
from academicodec_tpu_torch.ops.cuda import chain as chain_ops
from academicodec_tpu_torch.ops.cuda import lstm as lstm_ops
from academicodec_tpu_torch.ops.cuda import resblock as resblock_ops
from academicodec_tpu_torch.ops.cuda import rvq as rvq_ops
from academicodec_tpu_torch.ops.cuda import snake as snake_ops
from academicodec_tpu_torch.probes import int8_chain
from academicodec_tpu_torch.probes.int8_chain import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound, nvidia_smi
from academicodec_tpu_torch.quant.core_vq import KMEANS_ITERS, THRESHOLD_EMA_DEAD_CODE
from academicodec_tpu_torch.streaming import StreamingDecoder, StreamingEncoder, StreamingVQVAEDecoder
from academicodec_tpu_torch.utils import profiling

FLAGSHIP = "encodec_24k_240d"
HIFI = "hificodec_24k_320d"
# the token LM at cli/train_lm.py's default width (JAX cli/train_lm.py:57-60)
LM_WIDTH = dict(dim=200, num_heads=8, num_layers=5, past_context=1000)
# int8 takes hificodec_24k_320d's stages of 128 channels and more
INT8_MIN_CHANNELS = 128
# int8 card vs CPU, f32: the int8 quantizer is a step function, so inputs that
# differ by f32 rounding land on other integers at a few sites, and the one-LSB
# jumps grow along the 18-conv chains (on an H100: 0.9% of the int8 activations,
# every site's int32 sums on the same inputs exact, token mismatch 0.0398);
# the JAX contract's 1e-2 is for continuous paths
INT8_CROSS_TOKEN_LIMIT = 0.1


# K1-K4's launch counters (``utils/profiling.py``) by the kernel's name here
LAUNCH_COUNTERS = {"rvq_encode": "k1.launches", "lstm2": "k2.launches", "resblock_tower": "k3.launches",
                   "resblock_tower_gn": "k4.launches"}
PROBE_COUNTERS = {"conv_chain_bf16": "p1.launches", "conv_chain_i8": "p2.launches"}


def reset_launches() -> None:
    """K1-K4's counts to 0, and the int8 GEMM's (a library call, read apart
    from the kernels by :func:`int8_gemms`). The probe's P1/P2 counts
    (:func:`read_probe_launches`) are set to 0 by its own phase only, so that
    up to it they count every launch of the run: ``main`` holds them at 0
    over every serving and training phase."""
    profiling.reset(*LAUNCH_COUNTERS.values(), "int8.gemms")


def read_launches() -> dict:
    return {k: profiling.total(name).count for k, name in LAUNCH_COUNTERS.items()}


def read_probe_launches() -> dict:
    return {k: profiling.total(name).count for k, name in PROBE_COUNTERS.items()}


def int8_gemms() -> int:
    return profiling.total("int8.gemms").count


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


def k2_slstms(model) -> int:
    """The model's 2-layer SLSTMs, each one K2 launch a call; other layer counts run cuDNN's LSTM."""
    return sum(isinstance(m, SLSTM) and m.num_layers == 2 for m in model.modules())


def phase_main_path(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=5,
                    preset=FLAGSHIP, **overrides) -> dict:
    """One Encodec/SoundStream roundtrip through the public entry points,
    with the launch counts read around it; then ``iters`` timed roundtrips
    (on the card only). The codebooks are first spread over the latent
    frames of two of the input rows (:func:`spread_codebooks`). ``overrides``
    may set SEANet's ``norm`` and ``lstm``; K2 then runs once per 2-layer SLSTM."""
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    length = int(round(seconds * model.sample_rate))
    wav = seeded_wav(batch, length, device)
    spread_codebooks(model, latent_frames(model, wav[:2]))
    print(f"[main] {preset} {dtype} on {wav.device}, codebooks from latent frames")
    frames = math.ceil(length / model.hop_length)
    expected = {"rvq_encode": 1, "lstm2": k2_slstms(model), "resblock_tower": 0, "resblock_tower_gn": 0}
    result = checked_roundtrip("main", model, wav, expected, (model.n_q, batch, frames))
    result["distinct_tokens"] = check_distinct("main", result["codes"])
    if wav.device.type == "cuda" and iters:
        result.update(timed_roundtrips("main", model, wav, seconds, iters))
    return result


def phase_cross_check(device, preset=FLAGSHIP, seconds=0.3, batch=2, fused_pre=False, **overrides) -> None:
    """A full-width f32 model on the card against the same seeded model on
    the CPU (plain versions) on a small input: tokens, and the wav decoded
    from the same tokens. The codebooks are first spread over the CPU model's
    latent frames, identically on both. ``fused_pre``: HiFi-Codec's generator
    with its upsampling fused into K3; ``overrides`` go to both models."""
    wav = seeded_wav(batch, int(seconds * 24000), "cpu", seed=2)
    gpu = load_codec(preset, device=device, **overrides)
    cpu = load_codec(preset, device="cpu", **overrides)
    if fused_pre:
        gpu.generator.fused_pre = cpu.generator.fused_pre = True
        print(f"[cross] {preset} with generator.fused_pre")
    frames = latent_frames(cpu, wav)
    spread_codebooks(gpu, frames)
    spread_codebooks(cpu, frames)
    codes_cpu = cpu.encode(wav)
    mismatch = (gpu.encode(wav).cpu() != codes_cpu).double().mean().item()
    err = (gpu.decode(codes_cpu).cpu() - cpu.decode(codes_cpu)).abs().max().item()
    print(f"[cross] f32 {preset} {overrides or ''} card vs CPU, {batch} x {seconds} s: token mismatch "
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


def _tower_bound(B, C, T, ks, dss, itemsize, c_post=0, kp=0, c_in=0, k_pre=0, u=1, peak=PEAK_BF16_FLOPS):
    """Bound of one tower call: its convs' operations at the ``peak`` (bf16's), or
    the input, the output and the weights moved once. With the prologue
    (``c_in`` channels, stride ``u``, ``k_pre`` taps) the input is ``[B, c_in,
    T / u]`` and each output sample of the convT takes ``k_pre / u`` taps."""
    taps = sum(k * len(resblock_ops.chain_conv_dilations(ds, "1")) for k, ds in zip(ks, dss))
    flops = 2.0 * B * T * C * C * taps + 2.0 * B * T * C * c_post * kp + 2.0 * B * T * C * c_in * k_pre / u
    x_elems = B * c_in * T // u if c_in else B * C * T
    nbytes = itemsize * (x_elems + B * (c_post or C) * T + C * C * taps + c_post * C * kp + c_in * C * k_pre)
    return bound(flops, nbytes, peak)


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
             "40000-120000 frames (the bound counts the valid frames' operations); *_shard: pass 1 with "
             "its per-tile partials kept, on an interior time shard of a 60 s file over 4 shards "
             "(phase_sequence)", cases=cases,
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
        counters = ("k4.tiles", "k4.tiles_skipped")
        with torch.no_grad():
            before = [profiling.total(n).count for n in counters]
            y = resblock_ops.resblock_tower_gn(x, packed, None, scs, gbs, lengths=lengths, **gkw)  # host lengths
            tiles = [profiling.total(n).count - v for n, v in zip(counters, before)]
            ref = resblock_ops.resblock_tower_gn_plain(x, weights, biases, scs, gbs, kernel_sizes=ks,
                                                       dilation_sizes=dss, lengths=L, **gkw).float()
            err = (y.float() - ref).abs().max().item()
            pad_nonzero = sum(int(torch.count_nonzero(y[b, :, n:])) for b, n in enumerate(lengths))
            alone = max((y[b:b + 1, :, :n].float() - resblock_ops.resblock_tower_gn(
                x[b:b + 1, :, :n].contiguous(), packed, None, scs, gbs, **gkw).float()).abs().max().item()
                for b, n in enumerate(lengths))
        tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
        # the f32 kernel at C 64 skips the tiles past the lengths; the tensor-core path runs them all
        n_tiles, n_past = resblock_ops.k4_tiles(lengths, B, T, resblock_ops.gn_tile(packed))
        want = [n_tiles, n_past if resblock_ops.uses_fma_gn(dtype, C) else 0]
        print(f"[resblock_gn] {tag} {dtype} [{B},{C},{T}] lengths {lengths}: max abs diff {err:.3g} (atol {tol}); "
              f"nonzero pad values {pad_nonzero} (limit 0); each row against its exact-length call: max abs "
              f"diff {alone:.3g} (atol {tol}, 0 expected); k4.tiles, k4.tiles_skipped {tiles} (expected {want})")
        if not (err <= tol and pad_nonzero == 0 and alone <= tol and tiles == want):
            raise AssertionError(f"resblock_tower_gn with lengths disagrees ({tag})")
        case = dict(case=tag, shape=[B, C, T], lengths=lengths, max_abs_err=err, tolerance=tol,
                    pad_nonzero=pad_nonzero, max_abs_diff_vs_exact_length=alone, tiles=tiles[0],
                    tiles_skipped=tiles[1])
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
                  int8_min_channels=INT8_MIN_CHANNELS, lm_width=LM_WIDTH, preset=HIFI, **overrides) -> dict:
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
    seconds per wall second of the batched run.

    Then one more batched run with ``--int8_min_channels --tokens_ecdc --lm``:
    int8 serving calibrated on the first file, and a seeded LM of
    ``lm_width``, biased to the first batched run's tokens
    (:func:`bias_heads_to`), saved as a checkpoint directory. Every blob must
    decode to that run's own tokens, and the int8 GEMMs must have run."""
    import dataclasses
    import os
    import tempfile

    from academicodec_tpu_torch.cli import extract_tokens
    from academicodec_tpu_torch.data.wavio import write_wav

    model, wavs, lengths = extract_corpus(device, n_files, min_seconds, max_seconds, preset, **overrides)
    sr = model.config.sampling_rate
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
        n_codes = model.config.n_codes
        del model
        flags = ["--config", config, "--model_path", ckpt, "--input", os.path.join(tmp, "wavs"),
                 "--device", str(device)]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        extract_tokens.main(flags + ["--outputdir", os.path.join(tmp, "out_b"), "--tokens_out",
                                     os.path.join(tmp, "b.npz"), "--batch_files", str(n_files),
                                     "--bucket_seconds", str(bucket_seconds)])
        if on_card:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
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
        lm = RVQTokenLM(n_q=batched[keys[0]].shape[2], bins=n_codes, **lm_width, device=device)
        bias_heads_to(lm, np.concatenate([batched[k][0].T for k in keys], 1))
        save_lm(lm, os.path.join(tmp, "lm"), family="hificodec")
        reset_launches()
        extract_tokens.main(flags + ["--outputdir", os.path.join(tmp, "out_q"), "--tokens_out",
                                     os.path.join(tmp, "q.npz"), "--batch_files", str(n_files), "--bucket_seconds",
                                     str(bucket_seconds), "--int8_min_channels", str(int8_min_channels),
                                     "--tokens_ecdc", os.path.join(tmp, "ecdc_q"), "--lm", os.path.join(tmp, "lm")])
        gemms = int8_gemms()
        q_launches = read_launches()
        int8_tokens = np.load(os.path.join(tmp, "q.npz"))
        blobs = {k: open(os.path.join(tmp, "ecdc_q", f"{k}.ecdc"), "rb").read() for k in keys}
        lm_coded = sum(bool(binary.read_ecdc_header(io.BytesIO(b)).get("lm")) for b in blobs.values())
        blobs_exact = sorted(int8_tokens.files) == keys and all(
            np.array_equal(decompress_tokens(blobs[k], lm=lm)[0], int8_tokens[k][0].T) for k in keys)
        int8_differ = differ(batched, int8_tokens) if all(
            int8_tokens[k].shape == batched[k].shape for k in keys) else total
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
    print(f"[extract] --int8_min_channels {int8_min_channels} --tokens_ecdc --lm: {gemms} int8 GEMMs, launches "
          f"{q_launches}; {lm_coded} of {n_files} blobs LM-coded ({sum(map(len, blobs.values()))} bytes for "
          f"{total} tokens), every blob decodes to the run's tokens: {blobs_exact}; int8 vs f32 tokens differ in "
          f"{int8_differ} of {total}")
    if not (shapes_ok and mismatch <= 1e-3 and len(synth) == n_files and launches == expected):
        raise AssertionError(f"extract: mismatch {mismatch:.3g}, shapes {shapes_ok}, {len(synth)} wavs, "
                             f"launches {launches}")
    if not (blobs_exact and (gemms > 0) == on_card):
        raise AssertionError(f"extract --int8_min_channels --lm: blobs exact {blobs_exact}, {gemms} int8 GEMMs")
    result = {"launches": launches, "token_mismatch": mismatch, "distinct_tokens": distinct,
              "int8_lm": {"launches": q_launches, "int8_gemms": gemms, "lm_coded_blobs": lm_coded,
                          "blob_bytes": sum(map(len, blobs.values())), "tokens": total,
                          "tokens_differ_vs_f32": int8_differ},
              "audio_seconds": audio_s, "tokens_differ_batched_vs_padded_single": differ_b_p,
              "tokens_differ_padded_single_vs_exact": differ_p_s, "latent_max_abs_diff_padded_vs_exact": latent_diff}
    if on_card:
        result.update(wall_s=wall_s, audio_seconds_per_wall_second=audio_s / wall_s, peak_mem_gib=peak_gib)
        print(f"[extract] batched run {wall_s:.3f} s wall (model load, reads, encode, synthesis, writes): "
              f"{audio_s / wall_s:.1f} audio seconds per wall second, peak memory {peak_gib:.3f} GiB "
              f"({nvidia_smi()})")
    return result


def bias_heads_to(lm, codes: np.ndarray) -> None:
    """Stand in for training (as tests/test_lm_compress.py biases its heads):
    each head's bias becomes the log frequencies of its stream in ``codes
    [n_q, T]``, and its weights shrink 10x, so that the untrained trunk moves
    the logits by about 0.1 and LM coding beats raw packing."""
    with torch.no_grad():
        for q, head in enumerate(lm.heads):
            freq = np.bincount(codes[q], minlength=lm.bins) + 0.01
            head.bias.copy_(torch.from_numpy(np.log(freq / freq.sum())).float())
            head.weight.mul_(0.1)


def _host_s(fn, on_card):
    """``(fn(), seconds by the host clock)``, synchronized on the card."""
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_lm(device="cuda", dtype=torch.bfloat16, seconds=10.0, lm_width=LM_WIDTH, preset=FLAGSHIP,
             **overrides) -> dict:
    """LM entropy coding of one file: ``seconds`` of seeded audio through
    ``SoundStreamCompressor(lm=)`` (the encode runs K1 and K2, then the LM
    codes the ``n_q`` streams frame by frame) and back through
    ``decompress`` (LM decoding, then the decode, K2), with the launch
    counts read around both. The LM is seeded at ``lm_width`` with its heads
    biased to the file's tokens (:func:`bias_heads_to`), so the guard keeps
    the LM blob, which must decode to exactly ``model.encode``'s tokens and
    give ``model.decode``'s wav bitwise. A second, unbiased LM must make the
    guard keep the raw blob, byte-identical to ``compress_codes``'s. Prints
    bits per token, coder and decoder ms per frame (host clock), the LM
    step's wall time, the device's busy share while coding, and whether the
    card's blob decodes on the CPU (asserted on neither side: float pdfs of
    two device kinds need not agree bitwise). ``step_ms`` is the host clock of
    one LM step, which ends in the copy of its pdfs to the host."""
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    wav = seeded_wav(1, int(round(seconds * model.sample_rate)), "cpu", seed=8)
    spread_codebooks(model, latent_frames(model, wav))
    on_card = model.device.type == "cuda"
    codes = model.encode(wav).cpu().numpy()[:, 0]  # [n_q, T]
    n_q, T = codes.shape
    lm = RVQTokenLM(n_q=n_q, bins=model.bins, **lm_width, device=device)
    bias_heads_to(lm, codes)
    comp = SoundStreamCompressor(model, lm=lm)
    reset_launches()
    blob, compress_s = _host_s(lambda: comp.compress(wav[0].numpy()), on_card)
    (out, _), decompress_s = _host_s(lambda: comp.decompress(blob), on_card)
    launches = read_launches()
    expected = {"rvq_encode": 1, "lstm2": k2_slstms(model), "resblock_tower": 0, "resblock_tower_gn": 0}
    expected = {k: (n if on_card else 0) for k, n in expected.items()}
    header = binary.read_ecdc_header(io.BytesIO(blob))
    tokens_exact = np.array_equal(decompress_tokens(blob, lm=lm)[0], codes)
    ref = model.decode(torch.from_numpy(codes[:, None])).float().cpu().numpy()[0, :wav.shape[1]]
    wav_exact = np.array_equal(out, ref)
    raw = compress_codes(codes, bits_per_codebook=model.bits_per_codebook, metadata=comp._meta(wav.shape[1]))
    bits = dict(lm=len(blob) * 8 / codes.size, raw_blob=len(raw) * 8 / codes.size, raw_packing=model.bits_per_codebook)
    print(f"[lm] {preset} {dtype} 1 x {seconds} s: {n_q} x {T} tokens, LM {lm_width}; blob {len(blob)} bytes, "
          f"lm={header.get('lm')}, {bits['lm']:.4f} bits/token vs raw blob {bits['raw_blob']:.4f} (packing "
          f"{bits['raw_packing']}); tokens exact {tokens_exact}, wav equal to model.decode {wav_exact}; "
          f"launches {launches} (expected {expected})")
    if launches != expected or not (header.get("lm") and tokens_exact and wav_exact and len(blob) < len(raw)):
        raise AssertionError(f"lm: launches {launches}, lm {header.get('lm')}, tokens {tokens_exact}, "
                             f"wav {wav_exact}, {len(blob)} vs raw {len(raw)} bytes")
    plain = RVQTokenLM(n_q=n_q, bins=model.bins, **lm_width, device=device, seed=1)
    guarded = compress_tokens_guarded(codes, bits_per_codebook=model.bits_per_codebook,
                                      metadata=comp._meta(wav.shape[1]), lm=plain)
    print(f"[lm] an unbiased LM: the guard keeps the raw blob, byte-identical to compress_codes: {guarded == raw}")
    if guarded != raw:
        raise AssertionError("lm: with an unbiased LM the guard did not keep the raw blob")
    lm_blob, code_s = _host_s(lambda: compress_tokens_with_lm(lm, codes), on_card)
    _, decode_s = _host_s(lambda: decompress_tokens_with_lm(lm, lm_blob), on_card)
    result = {"launches": launches, "frames": T, "streams": n_q, "bits_per_token": bits,
              "coder_ms_per_frame": code_s / T * 1e3, "decoder_ms_per_frame": decode_s / T * 1e3,
              "compress_s": compress_s, "decompress_s": decompress_s}
    if on_card:
        step = make_step(lm)
        prev = torch.full((1, 1, n_q), lm.bins, dtype=torch.long, device=lm.device)
        _, states, offset = step(prev, None, None)
        _, step_s = _host_s(lambda: [step(prev, states, offset) for _ in range(20)], on_card)
        wall_ms, busy_ms, ops, _ = device_busy(lambda: compress_tokens_with_lm(lm, codes[:, :50]))
        result.update(step_ms=step_s / 20 * 1e3, profiled_frames=50, profiled_wall_ms=wall_ms,
                      device_busy_ms=busy_ms, device_ops_per_frame=ops / 50,
                      idle_share=None if busy_ms is None else max(0.0, 1 - busy_ms / wall_ms))
    cpu_lm = RVQTokenLM(n_q=n_q, bins=model.bins, **lm_width, device="cpu")
    cpu_lm.load_state_dict(lm.state_dict())
    try:
        result["card_blob_decodes_on_cpu"] = np.array_equal(decompress_tokens_with_lm(cpu_lm, lm_blob)[0], codes)
    except (EOFError, RuntimeError, AssertionError, ValueError):  # a desynchronized range decoder
        result["card_blob_decodes_on_cpu"] = False
    print(f"[lm] coder {result['coder_ms_per_frame']:.3f} ms/frame, decoder {result['decoder_ms_per_frame']:.3f} "
          f"ms/frame (host clock, {T} frames x {n_q} streams); one LM step {result.get('step_ms')} ms (host clock, "
          f"its launches and the copy of the pdfs to the host); coding 50 frames with the profiler on: device busy "
          f"{result.get('device_busy_ms')} ms of {result.get('profiled_wall_ms')} ms wall, "
          f"{result.get('device_ops_per_frame')} device operations a frame (idle share {result.get('idle_share')}); "
          f"the card's blob decodes on the CPU: "
          f"{result['card_blob_decodes_on_cpu']}" + (f" ({nvidia_smi()})" if on_card else ""))
    return result


def _int8_site_inputs(model, run) -> dict:
    """``{int8 conv path: its first input}`` while ``run()`` drives ``model``."""
    inputs, hooks = {}, []

    def record(name):
        def hook(module, args):
            inputs.setdefault(name, args[0].detach().clone())  # returns None: the input goes on unchanged
        return hook

    for name, conv in model.w8a8_convs().items():
        hooks.append(conv.register_forward_pre_hook(record(name)))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return inputs


def _int8_site_times(model, wav, iters=5) -> dict:
    """Each int8 stage's convs timed alone on seeded inputs of their shapes:
    the int8 conv (quantize, im2col, GEMM, dequantize), its int32 part (im2col
    and GEMM), and the cuDNN conv of the model's dtype it replaces; summed by
    stage (``encoder.s2``: the encoder's third stage)."""
    nk = len(model.config.resblock_kernel_sizes)
    shapes = {k: v.shape for k, v in _int8_site_inputs(model, lambda: model.decode(model.encode(wav))).items()}
    by_config: dict = {}  # convs of one input shape, kernel size and dilation take the same time
    for name, shape in shapes.items():
        conv = model.get_submodule(name)
        by_config.setdefault((tuple(shape), conv.fan_in, conv.dilation, conv.padding), []).append(name)
    stages: dict = {}
    g = torch.Generator(device=wav.device).manual_seed(10)
    for (shape, _, dil, pad), names in by_config.items():
        conv = model.get_submodule(names[0])
        x = torch.randn(shape, generator=g, device=wav.device).to(model.dtype)
        w, b = conv.resolved_weight().detach(), conv.bias.detach()
        scale = int8_ops.act_scale_from_amax(x.float().abs().max())
        xi = int8_ops.quantize_act(x, scale)
        wi, _ = int8_ops.quantize_kernel_per_cout(w)
        with torch.no_grad():
            t = dict(
                int8_ms=time_ms(lambda: int8_ops.conv1d_w8a8(x, w, b, scale, dilation=dil, padding=(pad, pad)), iters),
                int32_ms=time_ms(lambda: int8_ops.conv1d_int32(xi, wi, 1, dil, (pad, pad)), iters),
                cudnn_ms=time_ms(lambda: torch.nn.functional.conv1d(x, w.to(x.dtype), b.to(x.dtype), padding=pad,
                                                                    dilation=dil), iters),
            )
        for name in names:
            tower, _, block = name.split(".")[:3]
            st = stages.setdefault(f"{tower}.s{int(block) // nk}", dict(convs=0, channels=shape[1], frames=shape[2],
                                                                         int8_ms=0.0, int32_ms=0.0, cudnn_ms=0.0))
            st["convs"] += 1
            for k, v in t.items():
                st[k] += v
    return stages


def phase_int8(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=3, threshold=INT8_MIN_CHANNELS,
               cross_seconds=0.3, preset=HIFI, **overrides) -> dict:
    """W8A8 HiFi-Codec serving: the model with ``int8_min_channels=threshold``
    and the same seeded model without, codebooks spread over the same latent
    frames; the int8 model calibrated on one item (``calibrate_quant``), then
    one roundtrip of ``batch`` x ``seconds`` with the launch counts and the
    int8 GEMMs read around it (K3 and K4 still run the fused stages; one GEMM
    per int8 conv). The int8 decode of the bf16 tokens against the bf16
    decode: relative L2 error <= 0.12, JAX's bound (tests/test_int8.py:121);
    the token mismatch of the two encodes and the roundtrips' relative L2
    error are printed. On the card: both roundtrips timed in turns, and each
    int8 stage's convs against the cuDNN convs they replace. Then the card
    against the CPU (:func:`_int8_cross_check`)."""
    fp = load_codec(preset, device=device, dtype=dtype, **overrides)
    q = load_codec(preset, device=device, dtype=dtype, int8_min_channels=threshold, **overrides)
    wav = seeded_wav(batch, int(round(seconds * fp.config.sampling_rate)), device, seed=9)
    frames = latent_frames(fp, wav[:2])
    spread_codebooks(fp, frames)
    spread_codebooks(q, frames)
    calibrate_quant(q, wav[:1])
    on_card = wav.device.type == "cuda"
    sites = len(q.w8a8_convs())
    n_tok = q.quantizer.n_residual * q.quantizer.n_groups
    expected = {"rvq_encode": 0, "lstm2": 0, **fused_stage_counts(q.config)}
    result = checked_roundtrip("int8", q, wav, expected, (batch, -(-wav.shape[1] // q.hop_length), n_tok))
    gemms = int8_gemms()
    with torch.no_grad():
        codes_fp = fp.encode(wav)
        out_fp = fp.decode(codes_fp).float()
        out_q_same = q.decode(codes_fp).float()
    rel = ((out_q_same - out_fp).norm() / out_fp.norm()).item()
    rel_rt = ((result["wav"].float() - out_fp).norm() / out_fp.norm()).item()
    mismatch = (result["codes"] != codes_fp).double().mean().item()
    distinct = check_distinct("int8", codes_fp)
    print(f"[int8] {preset} {dtype}, int8_min_channels {threshold}: {sites} int8 convs, {gemms} int8 GEMMs in the "
          f"roundtrip (expected {sites if on_card else 0}); int8 decode of the bf16 tokens vs the bf16 decode: "
          f"relative L2 {rel:.4g} (limit 0.12); roundtrips: relative L2 {rel_rt:.4g}, token mismatch {mismatch:.4g}")
    if gemms != (sites if on_card else 0) or not rel <= 0.12:
        raise AssertionError(f"int8: {gemms} GEMMs for {sites} sites, relative L2 {rel:.4g}")
    out = {"launches": result["launches"], "int8_convs": sites, "int8_gemms": gemms, "wav_rel_l2_same_tokens": rel,
           "wav_rel_l2_roundtrip": rel_rt, "token_mismatch_vs_bf16": mismatch, "distinct_tokens": distinct}
    if on_card and iters:
        for tag, model in (("bf16", fp), ("int8", q), ("int8", q), ("bf16", fp)):
            timed = timed_roundtrips(f"int8 {tag}", model, wav, seconds, iters)
            if tag in out:
                timed = {k: (v + out[tag][k]) / 2 for k, v in timed.items()}
            out[tag] = timed
        out["stages"] = _int8_site_times(q, wav)
        for stage, t in out["stages"].items():
            print(f"[int8] {stage} ({t['channels']} ch x {t['frames']} frames, {t['convs']} convs): int8 "
                  f"{t['int8_ms']:.3f} ms (im2col + GEMM {t['int32_ms']:.3f}) vs cuDNN {dtype} {t['cudnn_ms']:.3f} ms")
    out.update(_int8_cross_check(device, preset, threshold, cross_seconds, **overrides))
    return out


def _int8_cross_check(device, preset, threshold, seconds, **overrides) -> dict:
    """The int8 model on the card against the CPU: f32, ``seconds`` x 2, the
    CPU's calibrated scales on both, codebooks spread as in :func:`phase_int8`.
    Each int8 site's int32 sums on the card equal the plain version's on the
    CPU's own inputs of that site (exactly); the int8 activations of the two
    runs, whose f32 inputs differ by float rounding, are counted where they
    land on different integers (the generators decode the CPU's tokens); then
    tokens (mismatch <= ``INT8_CROSS_TOKEN_LIMIT``) and the wav decoded from
    the CPU's tokens (atol 2e-4)."""
    cwav = seeded_wav(2, int(seconds * 24000), "cpu", seed=2)
    cframes = latent_frames(load_codec(preset, device="cpu", **overrides), cwav)
    cpu = load_codec(preset, device="cpu", int8_min_channels=threshold, **overrides)
    gpu = load_codec(preset, device=device, int8_min_channels=threshold, **overrides)
    spread_codebooks(cpu, cframes)
    spread_codebooks(gpu, cframes)
    calibrate_quant(cpu, cwav)
    gpu.load_quant({name: conv.act_amax for name, conv in cpu.w8a8_convs().items()})
    codes_cpu = cpu.encode(cwav)
    x_cpu = _int8_site_inputs(cpu, lambda: cpu.decode(cpu.encode(cwav)))
    x_gpu = _int8_site_inputs(gpu, lambda: (gpu.encode(cwav), gpu.decode(codes_cpu)))  # one set of tokens
    sums_exact, flips, total, first = True, {"encoder": 0, "generator": 0}, 0, {}
    for name, x in x_cpu.items():  # in the order the sites ran
        conv = cpu.get_submodule(name)
        scale = int8_ops.act_scale_from_amax(conv.act_amax)
        xi = int8_ops.quantize_act(x, scale)
        wi, _ = int8_ops.quantize_kernel_per_cout(conv.resolved_weight().detach())
        args = (1, conv.dilation, (conv.padding, conv.padding))
        card = int8_ops.conv1d_int32(xi.to(gpu.device), wi.to(gpu.device), *args).cpu()
        sums_exact &= torch.equal(card, int8_ops.conv1d_int32_plain(xi, wi, *args))
        differ = int((int8_ops.quantize_act(x_gpu[name].cpu(), scale) != xi).sum())
        flips[name.split(".")[0]] += differ
        first.setdefault(name.split(".")[0], (name, differ, xi.numel()))
        total += xi.numel()
    cross = (gpu.encode(cwav).cpu() != codes_cpu).double().mean().item()
    ref = cpu.decode(codes_cpu)
    diff = gpu.decode(codes_cpu).cpu() - ref
    err, rel = diff.abs().max().item(), (diff.norm() / ref.norm()).item()
    print(f"[int8] f32 card vs CPU, 2 x {seconds} s, the CPU's scales: int32 sums of all {len(x_cpu)} sites on "
          f"the CPU's inputs equal {sums_exact}; int8 activations on other integers {flips} of {total} (first "
          f"sites, whose inputs differ by f32 rounding only: {first}); token mismatch {cross:.3g} (limit "
          f"{INT8_CROSS_TOKEN_LIMIT}), wav from the same tokens max abs diff {err:.3g} (atol 2e-4), relative L2 "
          f"{rel:.3g}")
    check_distinct("int8 cross", codes_cpu)
    if not (sums_exact and cross <= INT8_CROSS_TOKEN_LIMIT and err <= 2e-4):
        raise AssertionError(f"int8: the card's int8 path disagrees with the CPU's: sums exact {sums_exact}, "
                             f"token mismatch {cross:.3g}, wav {err:.3g}")
    return {"cross_int32_sums_exact": sums_exact, "cross_int8_activations_differ": flips,
            "cross_int8_activations": total, "cross_first_sites": first, "cross_token_mismatch": cross,
            "cross_wav_max_abs_diff": err, "cross_wav_rel_l2": rel}


LAYER_OPTS = ({"norm": "time_group_norm"}, {"norm": "layer_norm"}, {"lstm": 3})


def phase_layer_opts(device="cuda", dtype=torch.bfloat16, batch=8, seconds=10.0, iters=3, cross_seconds=0.3,
                     stream_seconds=2.0, **overrides) -> dict:
    """The SEANet layer options at the flagship's widths: for each of
    ``LAYER_OPTS`` one roundtrip with its launch counts (K2 only for 2-layer
    SLSTMs; 3 layers run cuDNN's LSTM) and ``iters`` timed ones, then the card
    against the CPU (f32 at ``cross_seconds``: token mismatch <= 1e-2, wav
    atol 2e-4, more than 8 distinct tokens). Then the causal stream with a
    3-layer SLSTM, chunk by chunk against the whole call, in bf16 and f32."""
    out = {}
    for opts in LAYER_OPTS:
        tag = ",".join(f"{k}={v}" for k, v in opts.items())
        print(f"[layer_opts] {tag}")
        r = phase_main_path(device, dtype, batch, seconds, iters, **opts, **overrides)
        out[tag] = {k: r[k] for k in ("launches", "distinct_tokens", "roundtrip_ms", "realtime_factor",
                                      "peak_mem_gib") if k in r}
        if cross_seconds:
            phase_cross_check(device, FLAGSHIP, seconds=cross_seconds, **opts, **overrides)
    print("[layer_opts] causal stream, lstm=3")
    r = phase_stream(device, dtype, batch, stream_seconds, lstm=3, **overrides)
    out["stream_lstm=3"] = {k: v for k, v in r.items() if k not in ("launches", "profile")}
    if cross_seconds:
        out["stream_check_lstm=3"] = phase_stream_check(device, lstm=3, **overrides)
    return out


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
    expected = {"rvq_encode": n_chunks, "lstm2": k2_slstms(model) * n_chunks, "resblock_tower": 0,
                "resblock_tower_gn": 0}
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


def phase_stream_check(device, seconds=1.0, batch=2, **overrides) -> dict:
    """Streaming against the full causal call on the same card, f32 with TF32
    off, full width: Encodec tokens with codebooks spread over the latents
    (mismatch <= 2%, JAX's bound for
    shape-dependent near-tie flips, tests/test_streaming.py), Encodec wav
    decoded chunk by chunk from the full encode's tokens (atol 1e-4), and the
    HiFi-Codec generator's streaming decode of seeded tokens (atol 1e-4).
    ``overrides`` go to the Encodec model (SEANet's ``norm``, ``lstm``)."""
    model = load_codec(FLAGSHIP, device=device, causal=True, pad_mode="zero", **overrides)
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
    print(f"[stream_check] f32, {batch} x {seconds} s{' ' + str(overrides) if overrides else ''}: Encodec streaming vs full tokens ({distinct} distinct) mismatch {mismatch:.3g} "
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
        decode_ms=host_ms(lambda: model.decode(codes_dev[0])),
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


# ---------------------------------------------------------------------------
# training: the Encodec/SoundStream GAN trainer (train/encodec.py)

# Encodec_24k_240d at the recipe's settings (egs/Encodec_24k_240d/start.sh; f32,
# the reference discriminators), with every loss term live from the first step
TRAIN_RECIPE = dict(sr=24000, ratios=(6, 5, 4, 2), target_bandwidths=(1, 2, 4, 8, 12), n_filters=32,
                    dimension=512, bins=1024, discriminator_iter_start=1)
# card against the CPU: one step at a reduced width, TF32 off (phase_device)
TRAIN_CROSS = dict(TRAIN_RECIPE, n_filters=8, dimension=64, bins=64, stft_filters=8, stft_n_ffts=(1024,),
                   mpd_periods=(2, 3), msd_scales=1)
# limits of the card-vs-CPU step: losses rtol, each gradient leaf within this share
# of the larger of its max |g| and a hundredth of its phase's max |g|, the codebook
# state atol (+ rtol); codes equal. The floor: a leaf that is one sum with
# cancellation (the gain of a one-channel conv, a hinge's bias) carries f32
# noise of its terms' size, not of its own (the CPU on one thread against
# itself on 8 parts such leaves by ~1e-2 of their own max); the controls of
# _cross_controls show what a kernel fault moves instead (PERF.md section 6)
TRAIN_CROSS_LIMITS = dict(loss_rtol=1e-4, grad_rel=5e-3, codebook_atol=1e-4)


def train_launches(model, init_layers: int, accum: int = 1) -> dict:
    """K1 and K2 launches of one ``train_step`` by the trainer's code. After init:
    one K1 search per phase, and K2 only in the D phase's no-grad regenerate (once
    per 2-layer SLSTM; the G phase's SLSTMs run under autograd, in the library
    LSTM). An init step whose G phase draws every layer and inits
    ``init_layers`` of them searches layer by layer: per init layer its k-means'
    assignments (``KMEANS_ITERS`` Lloyd steps and the final buckets), per layer one
    search; its D phase searches once."""
    vq = model.quantizer.vq
    g = vq.num_quantizers + init_layers * (KMEANS_ITERS + 1) if init_layers else 1
    return {"rvq_encode": (g + 1) * accum, "lstm2": k2_slstms(model) * accum}


def _train_seconds(fn, on_card: bool) -> float:
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _train_run(tag, trainer, batch, seconds, steps, seed=0) -> dict:
    """An init step (every layer drawn in both phases, so that every layer's
    k-means runs in it), then ``steps`` steps with drawn bandwidths, each timed;
    launch counts of the init step and of the last, every loss finite."""
    from academicodec_tpu_torch.train.encodec import ForwardDraws, StepDraws

    on_card = trainer.device.type == "cuda"
    state = trainer.init_state(seed)
    model = state.generator
    x = seeded_wav(batch, int(round(seconds * trainer.cfg.sr)), trainer.device, seed=seed)
    n_q = model.quantizer.vq.num_quantizers
    drawn = trainer.draw(state, tuple(x.shape))
    draws = StepDraws(ForwardDraws(n_q, drawn.g.rows), ForwardDraws(n_q, drawn.d.rows))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out, losses = {}, []

    def step(d=None):
        nonlocal state
        state, metrics = trainer.train_step(state, x, draws=d)
        losses.append({k: float(v) for k, v in metrics.items()})

    reset_launches()
    init_s = _train_seconds(lambda: step(draws), on_card)
    init_launches = read_launches()
    times = []
    t0 = time.perf_counter()
    for _ in range(steps):
        reset_launches()
        times.append(_train_seconds(step, on_card))
    wall_s = time.perf_counter() - t0
    later_launches = read_launches()
    # the init step again on a fresh state, with every kernel and library call warm
    state = trainer.init_state(seed + 1)
    warm_s = _train_seconds(lambda: step(draws), on_card)
    expected_init = train_launches(model, n_q, trainer.cfg.accum_steps)
    expected = train_launches(model, 0, trainer.cfg.accum_steps)
    if not on_card:  # the plain versions launch nothing
        expected_init = expected = {k: 0 for k in expected}
    finite = all(math.isfinite(v) for m in losses for v in m.values())
    out.update(
        init_step_ms=init_s * 1e3, init_step_warm_ms=warm_s * 1e3, step_ms_median=statistics.median(times) * 1e3, step_ms_max=max(times) * 1e3,
        audio_s_per_s=batch * seconds * steps / wall_s, steps=steps, batch=batch, seconds=seconds,
        launches_init_step={k: init_launches[k] for k in expected_init},
        launches_step={k: later_launches[k] for k in expected}, expected_init_step=expected_init,
        expected_step=expected, losses_init_step=losses[0], losses_last_step=losses[-2],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        inited=all(model.quantizer.vq.inited_layers()),
    )
    print(f"[{tag}] {batch} x {seconds} s, {'bf16 mixed precision' if trainer.cfg.mixed_precision else 'f32'}: "
          f"init step {out['init_step_ms']:.1f} ms (the process's first; warm {out['init_step_warm_ms']:.1f}), "
          f"step median {out['step_ms_median']:.1f} ms (max "
          f"{out['step_ms_max']:.1f}) of {steps}, {out['audio_s_per_s']:.1f} audio s trained per wall s, peak memory "
          f"{out['peak_mem_gib'] if out['peak_mem_gib'] is None else round(out['peak_mem_gib'], 3)} GiB")
    print(f"[{tag}] launches: init step {out['launches_init_step']} (expected {expected_init}), a later step "
          f"{out['launches_step']} (expected {expected})")
    print(f"[{tag}] losses of the init step {losses[0]}; of the last timed step {losses[-2]}")
    if not finite:
        raise AssertionError(f"{tag}: a loss is not finite: {losses}")
    if out["launches_init_step"] != expected_init or out["launches_step"] != expected or not out["inited"]:
        raise AssertionError(f"{tag}: launches {out['launches_init_step']} / {out['launches_step']}, expected "
                             f"{expected_init} / {expected}")
    out["state"], out["x"] = state, x
    return out


def _k1_train_shapes(device, n=1600, d=512, k=1024, n_q=12, iters=10) -> dict:
    """K1 at the trainer's shapes against its plain version: the search of a
    batch of 16 x 1 s (N 1600 latent frames, 12 layers) and one k-means
    assignment (N 1600 against 1024 means drawn from the samples)."""
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((n, d), generator=g, device=device)
    embed = torch.randn((n_q, k, d), generator=g, device=device)
    means = x[torch.randperm(n, generator=torch.Generator().manual_seed(3))[:k].to(device)][None]
    out = {}
    for name, e in (("train", embed), ("kmeans", means)):
        codes, ref = rvq_ops.rvq_encode(x, e), rvq_ops.rvq_encode_plain(x, e)
        out[f"{name}_token_mismatch"] = (codes != ref).double().mean().item()
        out[f"{name}_ms"] = time_ms(lambda: rvq_ops.rvq_encode(x, e), iters)
        out[f"{name}_plain_ms"] = time_ms(lambda: rvq_ops.rvq_encode_plain(x, e), 3)
        layers = e.shape[0]
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound(
            2.0 * n * k * d * layers, 4.0 * (n * d + layers * k * d + layers * n), PEAK_F32_FLOPS)
        print(f"[train] K1 at N {n} x {list(e.shape)}: kernel {out[f'{name}_ms']:.4f} ms, plain "
              f"{out[f'{name}_plain_ms']:.4f} ms, bound {out[f'{name}_bound_ms']:.4f} ms "
              f"({out[f'{name}_bound_by']}), token mismatch {out[f'{name}_token_mismatch']:.3g} (limit 1e-4)")
    if not (out["train_token_mismatch"] <= 1e-4 and out["kmeans_token_mismatch"] <= 1e-4):
        raise AssertionError("rvq_encode disagrees with rvq_encode_plain at the training shapes")
    return out


def _k2_train_shapes(device, B=16, T=100, H=512, iters=20) -> dict:
    """K2 against its plain version at the shape of the D phase's no-grad
    regenerate of a batch of 16 x 1 s (x_proj [100, 16, 2048]): f32, as the f32
    step calls it, and with bf16 weights, as mixed precision does, at
    ``phase_lstm``'s tolerances. B 16 takes two MMA column tiles of 8 rows
    where the serving checks' B 8 takes one (csrc/lstm2.cu)."""
    slstm = SLSTM(H)
    slstm.lstm.reset_parameters(torch.Generator().manual_seed(2))
    g = torch.Generator(device=device).manual_seed(2)
    out = {}
    for tag, dtype, tol, rtol, peak in (("f32", torch.float32, 1e-4, 0.0, PEAK_F32_FLOPS),
                                        ("bf16", torch.bfloat16, 1e-2, 1e-2, PEAK_BF16_FLOPS)):
        mod = copy.deepcopy(slstm).to(device=device, dtype=dtype)
        x = (torch.randn((B, H, T), generator=g, device=device) * 0.5).to(dtype)
        with torch.no_grad():
            args = mod.recurrence_inputs(x)
            y = lstm_ops.lstm2(*args, out_dtype=dtype).float()
            ref = lstm_ops.lstm2_plain(*args, out_dtype=dtype).float()
            err = (y - ref).abs().max().item()
            ms = time_ms(lambda: lstm_ops.lstm2(*args, out_dtype=dtype), iters)
            plain_ms = time_ms(lambda: lstm_ops.lstm2_plain(*args, out_dtype=dtype), 2)
            # yardstick only: cuDNN's 2-layer LSTM on the same weights (it also projects the input)
            ref_lstm = torch.nn.LSTM(H, H, num_layers=2).to(device=device, dtype=dtype)
            ref_lstm.load_state_dict({k[len("lstm."):]: v for k, v in mod.state_dict().items()})
            ref_lstm.flatten_parameters()
            xt = x.permute(2, 0, 1).contiguous()
            library_ms = time_ms(lambda: ref_lstm(xt), iters)
        size = torch.finfo(dtype).bits // 8
        nbytes = T * B * 4 * H * 4 + 3 * 4 * H * H * size + 4 * H * 4 + T * B * H * size
        bound_ms, bound_by = bound(2.0 * 3 * 4 * H * H * B * T, nbytes, peak)
        out.update({f"train_{tag}_max_abs_err": err, f"train_{tag}_ms": ms, f"train_{tag}_plain_ms": plain_ms,
                    f"train_{tag}_bound_ms": bound_ms, f"train_{tag}_bound_by": bound_by,
                    f"train_{tag}_library_ms": library_ms})
        print(f"[train] K2 {tag} at x_proj [{T},{B},{4 * H}]: max abs diff {err:.3g} (atol {tol}, rtol {rtol}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), cuDNN LSTM "
              f"{library_ms:.4f} ms")
        if not torch.allclose(y, ref, atol=tol, rtol=rtol):
            raise AssertionError(f"lstm2 disagrees with lstm2_plain at the training shape in {tag}")
    return out


def spread_training_codebooks(model, wav: torch.Tensor, seed: int = 0) -> None:
    """A trained-looking codebook state for ``model`` over the latent frames of
    ``wav``, as tests/test_torch_soundstream.py spreads serving codebooks:
    entries N(0, std^2) per latent dimension; in layer 0 the frames' mean and,
    10 std away from it, the other entries, so that every frame takes the
    mean by a wide margin and the later layers see centred residuals with
    well-conditioned distances; cluster sizes 10 (no dead code: a replaced
    code is a copy of one frame, and a random encoder's frames at one
    position of every item lie close together, by the LSTM's transient from
    its zero state, so copies of them tie), EMA sums to match."""
    vq = model.quantizer.vq
    with torch.no_grad():
        e = model.encoder(wav[:, None, :].to(model.device)).transpose(1, 2).reshape(-1, vq.dim).float().cpu()
        embed = torch.randn(vq.embed.shape, generator=torch.Generator().manual_seed(seed)) * e.std(dim=0)
        embed[0] = e.mean(dim=0) + 10 * embed[0]
        embed[0, 0] = e.mean(dim=0)
        sizes = torch.full(vq.cluster_size.shape, 10.0)
        vq.embed.copy_(embed)
        vq.embed_avg.copy_(embed * sizes[..., None])
        vq.cluster_size.copy_(sizes)
        vq.set_inited(True)


def _captured_searches(model, run):
    """``run()``, and for each call of ``model``'s quantizer in it the CPU copies
    of its input latents ``[B, T, D]`` and of the codebooks it searched."""
    seen = []
    hook = model.quantizer.vq.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].detach().float().cpu(), mod.embed.detach().float().cpu())))
    try:
        out = run()
    finally:
        hook.remove()
    return out, seen


def _search_codes(model, wav: torch.Tensor, n_q: int):
    """The G phase's codes of ``wav`` (its SLSTMs under autograd, as in a step),
    with no EMA update: ``([n_q, B, frames] on the CPU, the search's latents
    and codebooks)``."""
    with torch.enable_grad():
        (_wav, _commit, codes), seen = _captured_searches(
            model, lambda: model(wav.to(model.device), n_q=n_q, training=False))
    return codes.cpu(), seen[0]


def _near_ties(search, codes_card: torch.Tensor, codes_cpu: torch.Tensor, items=None) -> list:
    """For each frame whose codes part between the card and the CPU, at the first
    layer they part: ``(item, frame, layer, margin, conditioning)``, the CPU's
    margin there, (second nearest - nearest) / nearest, and |r|^2 / nearest
    (the cancellation in ``|r|^2 - 2 r.e + |e|^2``), from the CPU search's
    latents and codebooks ``search``. ``items`` maps a batch row to its item."""
    latents, embed = search
    n_q, B, T = codes_cpu.shape
    items = list(range(B)) if items is None else items
    flat_cpu, differ = codes_cpu.reshape(n_q, -1).long(), (codes_card != codes_cpu).reshape(n_q, -1)
    r = latents.reshape(-1, latents.shape[-1])
    seen = torch.zeros(r.shape[0], dtype=torch.bool)
    out = []
    for layer in range(n_q):
        e = embed[layer]
        d = r.square().sum(1, keepdim=True) - 2 * r @ e.t() + e.square().sum(1)
        two = d.topk(2, dim=1, largest=False).values
        for i in (differ[layer] & ~seen).nonzero().flatten().tolist():
            out.append((items[i // T], i % T, layer, ((two[i, 1] - two[i, 0]) / two[i, 0].abs()).item(),
                        (r[i].square().sum() / two[i, 0].abs()).item()))
        seen |= differ[layer]
        r = r - e[flat_cpu[layer]]
    return out


def _cross_run(trainer, state, x, draws) -> dict:
    """One step; its losses, every gradient leaf (G and D), both phases' codes,
    the latents and codebooks of both phases' searches, and the codebook
    state after the step, on the CPU."""
    (state, metrics, codes), searches = _captured_searches(
        state.generator, lambda: trainer.train_step(state, x, draws=draws, return_codes=True))
    grads = {f"g.{n}": p.grad.float().cpu() for n, p in state.generator.named_parameters()}
    grads.update({f"d.{n}": p.grad.float().cpu() for n, p in state.discriminators.named_parameters()})
    vq = state.generator.quantizer.vq
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads, codes=codes["g"][0].cpu(),
                codes_d=codes["d"][0].cpu(), searches=searches,
                cb={n: getattr(vq, n).cpu() for n in ("embed", "embed_avg", "cluster_size")})


def _grad_compare(card: dict, cpu: dict) -> dict:
    """Gradient leaves ``{'g.name' | 'd.name': grad}`` of the card against the CPU's:
    each leaf against the larger of its own max |g| and a hundredth of its
    phase's (generator or discriminator) max |g| (TRAIN_CROSS_LIMITS); against
    its own max alone, reported."""
    floor = {p: max(g.abs().max().item() for n, g in cpu.items() if n.startswith(p)) / 100 for p in ("g.", "d.")}
    diff = {n: (card[n] - g).abs().max().item() for n, g in cpu.items()}
    own = {n: g.abs().max().item() for n, g in cpu.items()}
    grad_rel = {n: diff[n] / max(own[n], floor[n[:2]], 1e-30) for n in diff}
    grad_rel_own = {n: diff[n] / max(own[n], 1e-30) for n in diff}
    worst = sorted(grad_rel, key=grad_rel.get, reverse=True)[:3]
    worst_own = sorted(grad_rel_own, key=grad_rel_own.get, reverse=True)[:3]
    return dict(grad_max_rel_diff=grad_rel[worst[0]], grad_worst_leaves={n: grad_rel[n] for n in worst},
                grad_max_rel_diff_own=grad_rel_own[worst_own[0]],
                grad_worst_leaves_own={n: (grad_rel_own[n], own[n] / floor[n[:2]] / 100) for n in worst_own},
                grad_leaves=len(cpu), grad_rel=grad_rel, grad_diff=diff)


def _cross_compare(card: dict, cpu: dict, limits: dict) -> dict:
    loss_rel = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["metrics"].items()}
    grads = _grad_compare(card["grads"], cpu["grads"])
    grads.pop("grad_rel"), grads.pop("grad_diff")
    return dict(
        loss_max_rel_diff=max(loss_rel.values()), loss_rel_diff=loss_rel, **grads,
        codes_differ=int((card["codes"] != cpu["codes"]).sum()),
        codebook_max_abs_diff=max((card["cb"][n] - v).abs().max().item() for n, v in cpu["cb"].items()),
        codes_d_differ=int((card["codes_d"] != cpu["codes_d"]).sum()),
        codebook_close=all(torch.allclose(card["cb"][n], v, atol=limits["codebook_atol"],
                                          rtol=limits["codebook_atol"]) for n, v in cpu["cb"].items()),
        codes_equal=torch.equal(card["codes"], cpu["codes"]), distinct_codes=int(torch.unique(cpu["codes"]).numel()),
    )


def _cross_ok(out: dict, limits: dict) -> bool:
    """The step's check: losses, gradient leaves, codebook state, both phases' codes."""
    return (out["loss_max_rel_diff"] <= limits["loss_rtol"] and out["grad_max_rel_diff"] <= limits["grad_rel"]
            and out["codebook_close"] and out["codes_equal"] and out["codes_d_differ"] == 0
            and out["distinct_codes"] > MIN_DISTINCT_TOKENS)


def _held_step(card_tr, card_state, cpu_tr, cpu_state, start, x, parted, cpu_runs) -> dict:
    """The step from ``start`` on the items of ``x`` not in ``parted``, on the card
    and the CPU with the same draws. An item whose codes part in it (either
    phase) at a near-tie is set aside in turn, and the step runs again, up to 3 rounds;
    ``step_ties`` gives the CPU's margins where they parted, in that phase's
    own search. ``cpu_runs`` keeps the CPU's step of each set of items."""
    from academicodec_tpu_torch.train.encodec import ForwardDraws, StepDraws

    n_q = cpu_state.generator.quantizer.vq.num_quantizers
    parted, step_ties = set(parted), []
    for _round in range(3):
        keep = [i for i in range(x.shape[0]) if i not in parted]
        if tuple(keep) not in cpu_runs:
            cpu_state.load_state_dict(start)
            drawn = cpu_tr.draw(cpu_state, (len(keep), x.shape[1]))
            draws = StepDraws(ForwardDraws(n_q, drawn.g.rows), ForwardDraws(n_q, drawn.d.rows))
            cpu_runs[tuple(keep)] = draws, _cross_run(cpu_tr, cpu_state, x[keep], draws)
        draws, cpu = cpu_runs[tuple(keep)]
        card_state.load_state_dict(start)
        card = _cross_run(card_tr, card_state, x[keep], draws)
        split = [tie for phase, codes in enumerate(("codes", "codes_d"))
                 for tie in _near_ties(cpu["searches"][phase], card[codes], cpu[codes], keep)]
        step_ties += split
        parted |= {item for item, *_ in split}
        if not split or any(margin >= NEAR_TIE_MARGIN for *_, margin, _cond in split):
            break  # held, or failed: a parting away from a near-tie
    return dict(card=card, cpu=cpu, keep=keep, draws=draws, step_ties=step_ties, parted=sorted(parted))


def _held_check(held: dict, ties: list, batch: int, limits: dict) -> tuple:
    """``(passes, comparison)`` of a held step: every parting at a near-tie, at
    most half of the items set aside, and :func:`_cross_ok`."""
    out = _cross_compare(held["card"], held["cpu"], limits)
    ties_ok = (all(margin < NEAR_TIE_MARGIN for *_, margin, _cond in ties + held["step_ties"])
               and len(held["parted"]) <= batch // 2)
    return ties_ok and _cross_ok(out, limits), out


def _cross_controls(card_tr, card_state, cpu_tr, cpu_state, start, x, ties, held, cpu_runs, limits) -> dict:
    """Controls of the held step, from ``start`` with the probe's items set
    aside: the CPU's step on one thread against the CPU's (another reduction
    order: the f32 noise of each leaf); then the whole check again with a
    fault on the card: K2's output off by a relative 1e-2, 1e-3 and 1e-4 (every
    K2 launch of the D phase's regenerate), and K1 giving, for every 97th row
    of each search, the next code instead of the nearest. The K1 fault and
    K2's at 1e-2 must fail the check; the smaller K2 faults are reported (at
    a tiny width the D phase's few codes may not see them)."""
    from academicodec_tpu_torch.nn import lstm as nn_lstm
    from academicodec_tpu_torch.quant import core_vq

    out = {}
    keep = held["keep"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu_state.load_state_dict(start)
        order = _cross_compare(_cross_run(cpu_tr, cpu_state, x[keep], held["draws"]), held["cpu"], limits)
    finally:
        torch.set_num_threads(threads)
    out["cpu_one_thread"] = {k: order[k] for k in ("loss_max_rel_diff", "grad_max_rel_diff", "grad_max_rel_diff_own",
                                                   "grad_worst_leaves_own")}
    lstm2, rvq_encode = nn_lstm.lstm2, core_vq.rvq_encode

    def k2_off(delta):
        return lambda *a, **kw: lstm2(*a, **kw) * (1 + delta)

    def k1_off(x_, embed):
        codes = rvq_encode(x_, embed).clone()
        codes[:, ::97] = (codes[:, ::97] + 1) % embed.shape[1]
        return codes

    faults = [(f"k2_{delta:g}", nn_lstm, "lstm2", k2_off(delta)) for delta in (1e-2, 1e-3, 1e-4)]
    for tag, target, name, fault in faults + [("k1_next_code", core_vq, "rvq_encode", k1_off)]:
        original = getattr(target, name)
        setattr(target, name, fault)
        try:
            bad = _held_step(card_tr, card_state, cpu_tr, cpu_state, start, x, {i for i, *_ in ties}, cpu_runs)
        finally:
            setattr(target, name, original)
        ok, cmp = _held_check(bad, ties, x.shape[0], limits)
        out[tag] = dict(caught=not ok, items_set_aside=len(bad["parted"]),
                        parted_at_near_ties=sum(m < NEAR_TIE_MARGIN for *_, m, _c in bad["step_ties"]),
                        parted_frames=len(bad["step_ties"]), loss_max_rel_diff=cmp["loss_max_rel_diff"],
                        grad_max_rel_diff=cmp["grad_max_rel_diff"], codes_differ=cmp["codes_differ"],
                        codes_d_differ=cmp["codes_d_differ"])
    print(f"[train] controls of the step: the CPU on one thread against the CPU {out['cpu_one_thread']}; "
          + "; ".join(f"{k} {v}" for k, v in out.items() if k != "cpu_one_thread"))
    if not (out["k1_next_code"]["caught"] and out["k2_0.01"]["caught"]):
        raise AssertionError(f"train: a fault passed the card-vs-CPU step check: {out}")
    return out


# codes may part between the card and the CPU only at a near-tie: a CPU margin,
# (second nearest - nearest) / nearest, below this (the latents of the two part
# by ~2e-6 relative at TRAIN_CROSS, H100), in at most half of the items (at these
# margins about one search in 3,000 parts, and a step makes 2 x 12 x 400)
NEAR_TIE_MARGIN = 1e-4


def _train_cross(device, batch=16, seconds=0.25, cross=TRAIN_CROSS, limits=TRAIN_CROSS_LIMITS) -> dict:
    """A reduced-width trainer on the card and on the CPU, at lr 0, so that the D
    phase regenerates from the weights both hold (AdamW moves a weight by
    about ``lr * sign(g)``, which a gradient near 0 splits). From one seeded
    state with the same draws, the init step (k-means of every drawn layer)
    runs on both and is reported only: on the latents of a random encoder,
    k-means codebooks leave distances ill conditioned (|r|^2 far above the
    nearest distance), and 50 Lloyd steps amplify f32 differences at
    near-ties. Then the CPU's state after it, with its codebooks spread over
    the next batch's latent frames (:func:`spread_training_codebooks`), is
    loaded by both. The G phase's search of that batch runs on both: where
    codes part, it must be at a near-tie (``NEAR_TIE_MARGIN``; the devices'
    f32 latents differ by ~1e-6), and those items are set aside. The step
    (every layer drawn in both phases), one search per phase, then runs on the
    other items. Where its codes part (the D phase searches codebooks that
    the G phase's EMA moved), the CPU's margins in that phase's own search
    must show a near-tie too; those items are set aside and the step runs
    again from the same state, at most half of the items in all. The step
    is held to ``limits``: losses, every gradient leaf of both phases
    (:func:`_cross_compare`), the codebook state after the step, both
    phases' codes equal; then :func:`_cross_controls`. Dead-code replacement is held card against CPU by
    tests/test_torch_cuda.py (``ResidualVQ``'s training forward) and
    reported in the init step here."""
    from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer

    cfg = EncodecTrainConfig(**cross, lr=0.0)
    card_tr, cpu_tr = EncodecTrainer(cfg, device=device), EncodecTrainer(cfg, device="cpu")
    card_state, cpu_state = card_tr.init_state(7), cpu_tr.init_state(7)
    length = int(round(seconds * cfg.sr))
    x = seeded_wav(batch, length, "cpu", seed=7)
    draws = cpu_tr.draw(cpu_state, tuple(x.shape))
    init = _cross_compare(_cross_run(card_tr, card_state, x, draws), _cross_run(cpu_tr, cpu_state, x, draws), limits)
    x = seeded_wav(batch, length, "cpu", seed=8)
    spread_training_codebooks(cpu_state.generator, x)
    start = copy.deepcopy(cpu_state.state_dict())
    card_state.load_state_dict(start)
    n_q = cpu_state.generator.quantizer.vq.num_quantizers
    (probe_card, _), (probe_cpu, probe_search) = (_search_codes(card_state.generator, x, n_q),
                                                  _search_codes(cpu_state.generator, x, n_q))
    ties = _near_ties(probe_search, probe_card, probe_cpu)
    cpu_runs = {}
    held = _held_step(card_tr, card_state, cpu_tr, cpu_state, start, x, {item for item, *_ in ties}, cpu_runs)
    ok, out = _held_check(held, ties, batch, limits)
    keep, draws, step_ties, parted = held["keep"], held["draws"], held["step_ties"], held["parted"]
    out.update(limits=limits, n_q_g=draws.g.n_q, n_q_d=draws.d.n_q, init_step=init, near_ties=ties,
               near_ties_in_step=step_ties, near_tie_margin=NEAR_TIE_MARGIN, items_set_aside=parted,
               items_held=len(keep))
    print(f"[train] card vs CPU at n_filters {cross['n_filters']}, D {cross['dimension']}, {cross['bins']} bins, "
          f"f32, lr 0: the init step (reported): losses {init['loss_max_rel_diff']:.3g} apart, {init['codes_differ']} "
          f"codes differ; the next batch's search parts at {len(ties)} frames (item, frame, layer, CPU margin, "
          f"|r|^2/nearest: {ties}; limit: margins below {NEAR_TIE_MARGIN}); in the step at {len(step_ties)} frames "
          f"({step_ties}; the same limit); {len(parted)} items set aside in all (limit {batch // 2})")
    print(f"[train] the step on the other {len(keep)} items: losses max rel diff {out['loss_max_rel_diff']:.3g} "
          f"(limit {limits['loss_rtol']}), {out['grad_leaves']} gradient leaves max diff "
          f"{out['grad_max_rel_diff']:.3g} of their scale (limit {limits['grad_rel']}; worst "
          f"{out['grad_worst_leaves']}; of their own max |g| {out['grad_max_rel_diff_own']:.3g}, worst (diff, own max "
          f"/ phase max) {out['grad_worst_leaves_own']}), codebook state max abs "
          f"diff {out['codebook_max_abs_diff']:.3g} (limit atol = rtol = {limits['codebook_atol']}), codes equal "
          f"{out['codes_equal']} ({out['distinct_codes']} distinct, floor {MIN_DISTINCT_TOKENS})")
    if not ok:
        raise AssertionError(f"train: the card's step disagrees with the CPU's: {out}")
    out["controls"] = _cross_controls(card_tr, card_state, cpu_tr, cpu_state, start, x, ties, held, cpu_runs, limits)
    return out


def _train_cli(device, n_files=32, file_seconds=1.5, batch=16, segment_seconds=1.0, width=TRAIN_RECIPE) -> dict:
    """``cli.train_encodec`` end to end: ``n_files`` seeded wavs, 2 epochs at the
    flagship widths with the debug discriminators, ``--resume`` for one more
    (the step must go on from the checkpoint), then ``cli.compress
    --resume_path`` on the newest checkpoint for one file, whose ``.ecdc`` blob
    is decompressed and decoded again."""
    import os
    import tempfile

    from academicodec_tpu_torch.cli import compress as compress_cli
    from academicodec_tpu_torch.cli import train_encodec
    from academicodec_tpu_torch.data.wavio import read_wav, write_wav
    from academicodec_tpu_torch.utils.checkpoint import checkpoint_step, scan_checkpoint

    sr = width["sr"]
    flags = ["--sr", str(sr), "--ratios", *map(str, width["ratios"]),
             "--target_bandwidths", *map(str, width["target_bandwidths"]),
             "--n_filters", str(width["n_filters"]), "--dimension", str(width["dimension"]),
             "--bins", str(width["bins"]), "--device", str(device)]
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "wavs"), os.path.join(tmp, "ckpt")
        os.makedirs(data)
        for i in range(n_files):
            write_wav(os.path.join(data, f"w{i:02d}.wav"),
                      (rng.standard_normal(int(file_seconds * sr)) * 0.1).astype(np.float32), sr)
        argv = ["--train_data_path", data, "--valid_data_path", data, "--path", out, *flags,
                "--batch_size", str(batch), "--segment_seconds", str(segment_seconds), "--n_epochs", "1",
                "--discriminator_iter_start", "1", "--debug_tiny_discs", "--print_freq", "1"]
        t0 = time.perf_counter()
        train_encodec.main(argv)
        first = scan_checkpoint(out, "latest")
        argv[argv.index("--n_epochs") + 1] = "2"
        train_encodec.main(argv + ["--resume"])
        wall_s = time.perf_counter() - t0
        latest = scan_checkpoint(out, "latest")
        steps_per_epoch = n_files // batch
        step_first, step_last = checkpoint_step(first), checkpoint_step(latest)
        log = open(os.path.join(out, "logs", "log.txt")).read()
        one = os.path.join(tmp, "one")
        os.makedirs(one)
        os.link(os.path.join(data, "w00.wav"), os.path.join(one, "w00.wav"))
        served = os.path.join(tmp, "served")
        compress_cli.main(["--input", one, "--output", served, "--resume_path", latest, *flags,
                           "--target_bw", str(width["target_bandwidths"][-1]), "--ecdc"])
        blob = open(os.path.join(served, "w00.ecdc"), "rb").read()
        wav_cli, _ = read_wav(os.path.join(served, "w00.wav"))
        model = soundstream_from_checkpoint(latest, width, device)
        codes, _meta = decompress_codes(blob)
        with torch.no_grad():
            wav = model.decode(torch.as_tensor(codes)[:, None, :]).float().cpu().numpy()[0]
    n = min(len(wav), len(wav_cli))
    # the CLI's wav is PCM16 (steps of 1/32767), clipped to [-1, 1]
    inside = np.abs(wav[:n]) < 0.999
    wav_diff = float(np.abs(wav[:n] - wav_cli[:n])[inside].max())
    result = dict(epochs=3, steps_after_two_epochs=step_first, steps_after_resume=step_last, wall_s=wall_s,
                  ecdc_bytes=len(blob), decoded_samples=len(wav), decoded_vs_cli_wav_max_abs_diff=wav_diff)
    print(f"[train] cli: 2 epochs -> step {step_first}, --resume 1 epoch -> step {step_last} "
          f"({steps_per_epoch} steps an epoch; {wall_s:.1f} s wall); cli.compress --resume_path {os.path.basename(latest)}: "
          f"{len(blob)} bytes, decoded {len(wav)} samples, {wav_diff:.3g} from the CLI's PCM16 wav")
    if not (step_first == 2 * steps_per_epoch and step_last == 3 * steps_per_epoch
            and "resumed from" in log and np.isfinite(wav).all() and len(wav) == int(file_seconds * sr)
            and wav_diff <= 2.0 / 32767):
        raise AssertionError(f"train cli: {result}")
    return result


def soundstream_from_checkpoint(path, width, device):
    """The SoundStream of a training checkpoint, as ``cli.compress`` builds it."""
    from academicodec_tpu_torch.api import reference_state_dict
    from academicodec_tpu_torch.models.soundstream import SoundStream
    from academicodec_tpu_torch.utils.checkpoint import load_checkpoint

    model = SoundStream(n_filters=width["n_filters"], dimension=width["dimension"], ratios=width["ratios"],
                        sample_rate=width["sr"], target_bandwidths=width["target_bandwidths"], bins=width["bins"],
                        device=device)
    model.load_state_dict(reference_state_dict(load_checkpoint(path)))
    return model


def phase_train(device="cuda", batch=16, seconds=1.0, steps=8, mp_steps=2, profile_steps=5,
                recipe=TRAIN_RECIPE, cross=TRAIN_CROSS, cross_batch=16, cross_seconds=0.25, cli_width=TRAIN_RECIPE,
                cli_files=32,
                cli_batch=16, cli_segment_seconds=1.0) -> dict:
    """The Encodec/SoundStream GAN trainer through ``train.encodec.EncodecTrainer``
    (what ``cli.train_encodec`` calls): (a) ``recipe`` at ``batch`` x ``seconds``
    seeded noise, f32: an init step and ``steps`` timed steps, launch counts
    against :func:`train_launches`, every loss finite; the device's idle share
    over ``profile_steps`` steps (torch.profiler); then ``mixed_precision`` for an
    init step and ``mp_steps`` more. K1 at the trainer's shapes. (b) card
    against CPU (:func:`_train_cross`). (c) the CLI end to end (:func:`_train_cli`)."""
    from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer

    on_card = torch.device(device).type == "cuda"
    result = {}
    trainer = EncodecTrainer(EncodecTrainConfig(**recipe), device=device)
    f32 = _train_run("train", trainer, batch, seconds, steps)
    state, x = f32.pop("state"), f32.pop("x")
    if on_card and profile_steps:
        def run_one():
            nonlocal state
            state, _m = trainer.train_step(state, x)

        f32.update(_profile_steps(run_one, profile_steps))
        wall_ms, busy_ms, ops = f32["profiled_wall_ms"], f32["device_busy_ms"], f32["device_ops_per_step"] * profile_steps
        print("[train] device ms a step by kernel, top 12: "
              + "; ".join(f"{k[:60]} {v:.2f}" for k, v in f32["top_device_ms_per_step"].items()))
        # PyTorch's default for cuDNN convs (TF32), which the CLI keeps; the runs above are strict f32
        torch.backends.cudnn.allow_tf32 = True
        try:
            times = []
            for _ in range(3):
                times.append(_train_seconds(lambda: run_one(), on_card))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        f32["step_ms_median_cudnn_tf32"] = statistics.median(times) * 1e3
        print(f"[train] with cuDNN's TF32 convs (PyTorch's default): step median "
              f"{f32['step_ms_median_cudnn_tf32']:.1f} ms of 3")
        print(f"[train] profiled {profile_steps} steps: wall {wall_ms:.1f} ms, device busy "
              f"{'not measured' if busy_ms is None else f'{busy_ms:.1f} ms'}, idle share {f32['idle_share']}, "
              f"{ops / profile_steps:.0f} device operations a step ({nvidia_smi()})")
    del state, x
    result["f32"] = f32
    mp = _train_run("train_mp", EncodecTrainer(EncodecTrainConfig(**recipe, mixed_precision=True), device=device),
                    batch, seconds, mp_steps)
    mp.pop("state"), mp.pop("x")
    result["mixed_precision"] = mp
    if on_card:
        result["k1_shapes"] = _k1_train_shapes(device)
        result["k2_shapes"] = _k2_train_shapes(device)
    result["cross"] = _train_cross(device, batch=cross_batch, seconds=cross_seconds, cross=cross)
    result["cli"] = _train_cli(device, n_files=cli_files, batch=cli_batch, segment_seconds=cli_segment_seconds,
                               width=cli_width)
    return result


# ---------------------------------------------------------------------------
# HiFi-Codec training and token-LM training

HIFI_RECIPE_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes", "HiFi-Codec-24k-320d",
                                "config_24k_320d.json")
# the reference's discriminators (HiFiCodecTrainConfig's defaults, reference train.py:77-79)
HIFI_TRAIN_DISCS = dict(stft_filters=32, stft_n_ffts=(1024, 2048, 512, 256, 128), mpd_periods=(2, 3, 5, 7, 11),
                        msd_scales=3)
# card against the CPU: the recipe with narrower stages (generator 128 -> 8 and
# encoder 16 -> 128 channels, so that 4 generator stages take K3 and 3 encoder
# stages K4), two MS-STFT scales' worth of filters, two periods, two scales
# (the first spectral-normed); nothing of the step's structure is cut
HIFI_CROSS_MODEL = dict(upsample_initial_channel=128, encoder_base_channels=8)
HIFI_CROSS_DISCS = dict(stft_filters=8, stft_n_ffts=(1024,), mpd_periods=(2, 3), msd_scales=2)
# limits of the card-vs-CPU step: losses rtol, each gradient leaf as TRAIN_CROSS_LIMITS
# holds it or within noise_factor times its f32 noise, the larger of its own
# differences between the CPU on two thread counts and between the card with and
# without cuDNN (a bias summed over every frame, such as the first upsampling's,
# cancels to about its terms' f32 noise at this width: 1.1e-2 of its scale card
# against CPU on an H100's machine, 7.4x the CPU's noise), the spectral norm's u atol (a unit vector),
# each generator forward's wav (the D phase's on K3/K4) within this share of its
# max |value|; codes equal
HIFI_CROSS_LIMITS = dict(loss_rtol=1e-4, grad_rel=5e-3, noise_factor=4.0, u_atol=1e-5, wav_rel=1e-4)
TOWER_LIMITS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # K3/K4 vs plain, x max |plain| (phase_resblock's)


def hifi_recipe(**overrides):
    """``(HiFiCodecConfig, raw JSON)`` of hificodec_24k_320d's recipe, with ``overrides``."""
    import dataclasses

    from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig

    with open(HIFI_RECIPE_JSON) as fh:
        raw = json.load(fh)
    return dataclasses.replace(HiFiCodecConfig.from_json(raw), **overrides), raw


def _profile_steps(run_one, steps: int) -> dict:
    """The device's busy and idle share over ``steps`` calls of ``run_one``
    (torch.profiler) and the top device kernels a step."""
    def run():
        for _ in range(steps):
            run_one()

    wall_ms, busy_ms, ops, prof = device_busy(run)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / steps
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return dict(profiled_steps=steps, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_ops_per_step=ops / steps, top_device_ms_per_step=top,
                idle_share=None if busy_ms is None else max(0.0, 1 - busy_ms / wall_ms))


def _watch_gen(trainer, run):
    """``run()`` with each of ``trainer``'s generator forwards watched, by whether
    autograd recorded it (``no_grad``: the D phase's, ``grad``: the G phase's):
    ``(K3/K4 launches summed by phase, wav outputs by phase on the CPU, run's
    result)``."""
    names = ("resblock_tower", "resblock_tower_gn")
    counts = {"no_grad": dict.fromkeys(names, 0), "grad": dict.fromkeys(names, 0)}
    wavs = {"no_grad": [], "grad": []}
    gen = trainer._gen

    def watched(model, y):
        before = read_launches()
        out = gen(model, y)
        after = read_launches()
        phase = "grad" if torch.is_grad_enabled() else "no_grad"
        for k in names:
            counts[phase][k] += after[k] - before[k]
        wavs[phase].append(out[0].detach().float().cpu())
        return out

    trainer._gen = watched
    try:
        out = run()
    finally:
        del trainer._gen
    return counts, wavs, out


def _hifi_train_run(tag, trainer, batch, samples, steps, seed=0) -> dict:
    """A first step, then ``steps`` timed steps on ``batch`` x ``samples`` seeded
    noise (codebooks spread over its latents), then one ``eval_step``; K3/K4
    launches of the first step by phase and of the eval, every loss finite."""
    on_card = trainer.device.type == "cuda"
    state = trainer.init_state(seed)
    model = state.generator
    x = seeded_wav(batch, samples, trainer.device, seed=seed)
    spread_codebooks(model, latent_frames(model, x), seed=seed)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = []

    def step():
        nonlocal state
        state, metrics = trainer.train_step(state, x)
        losses.append({k: float(v) for k, v in metrics.items()})

    reset_launches()
    by_phase, _wavs, first_s = _watch_gen(trainer, lambda: _train_seconds(step, on_card))
    first_launches = read_launches()
    times = []
    t0 = time.perf_counter()
    for _ in range(steps):
        times.append(_train_seconds(step, on_card))
    wall_s = time.perf_counter() - t0
    reset_launches()
    evals = {k: float(v) for k, v in trainer.eval_step(state, x).items()}
    eval_launches = read_launches()
    expected = {k: (n if on_card else 0) for k, n in fused_stage_counts(trainer.cfg.model).items()}
    step_launches = {k: first_launches[k] for k in expected}
    out = dict(
        first_step_ms=first_s * 1e3, step_ms_median=statistics.median(times) * 1e3, step_ms_max=max(times) * 1e3,
        audio_s_per_s=batch * samples / trainer.cfg.model.sampling_rate * steps / wall_s, steps=steps,
        batch=batch, samples=samples, launches_step=step_launches, launches_by_phase=by_phase,
        launches_eval={k: eval_launches[k] for k in expected}, expected_step=expected,
        losses_first_step=losses[0], losses_last_step=losses[-1], eval=evals,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
    )
    precision = "bf16 mixed precision" if trainer.cfg.mixed_precision else "f32"
    print(f"[{tag}] {batch} x {samples} samples, {precision}: first step {out['first_step_ms']:.1f} ms, step "
          f"median {out['step_ms_median']:.1f} ms (max {out['step_ms_max']:.1f}) of {steps}, "
          f"{out['audio_s_per_s']:.2f} audio s trained per wall s, peak memory "
          f"{out['peak_mem_gib'] if out['peak_mem_gib'] is None else round(out['peak_mem_gib'], 3)} GiB")
    print(f"[{tag}] K3/K4 launches: a step {step_launches} (expected {expected}), by phase {by_phase} (the G "
          f"phase's must be 0), eval_step {out['launches_eval']}; losses {losses[0]} -> {losses[-1]}; eval {evals}")
    finite = all(math.isfinite(v) for m in losses + [evals] for v in m.values())
    if not finite:
        raise AssertionError(f"{tag}: a loss is not finite: {losses} {evals}")
    if (step_launches != expected or by_phase["no_grad"] != expected or any(by_phase["grad"].values())
            or out["launches_eval"] != expected):
        raise AssertionError(f"{tag}: K3/K4 launches {step_launches} {by_phase} eval {out['launches_eval']}, "
                             f"expected {expected} in the D phase's forward and the eval, 0 in the G phase")
    out["state"], out["x"] = state, x
    return out


def _tower_calls(model, x) -> list:
    """Every K3/K4 call of a no-grad forward of ``model`` on ``x``: ``(name, args,
    kwargs, output)``."""
    from academicodec_tpu_torch.nn import hifigan

    calls, originals = [], {n: getattr(hifigan, n) for n in ("resblock_tower", "resblock_tower_gn")}

    def recorder(name):
        def call(*args, **kwargs):
            y = originals[name](*args, **kwargs)
            calls.append((name, args, kwargs, y))
            return y
        return call

    for name in originals:
        setattr(hifigan, name, recorder(name))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for name, fn in originals.items():
            setattr(hifigan, name, fn)
    return calls


def _tower_plain(name, args, kwargs) -> torch.Tensor:
    x, p = args[0], args[1]
    chain = dict(kernel_sizes=p.kernel_sizes, dilation_sizes=p.dilation_sizes, resblock=p.resblock)
    if name == "resblock_tower":
        return resblock_ops.resblock_tower_plain(
            x, p.weights, p.biases, post_weight=p.post_weight, post_bias=p.post_bias,
            post_tanh=kwargs.get("post_tanh", False), pre_weight=p.pre_weight, pre_bias=p.pre_bias,
            pre_stride=p.pre_stride, pre_pad=p.pre_pad, **chain)
    return resblock_ops.resblock_tower_gn_plain(x, p.weights, p.biases, args[3], args[4], **chain, **kwargs)


def _hifi_train_towers(model, x, iters=5) -> dict:
    """K3/K4 at the trainer's shapes: each call of the D phase's no-grad generator
    forward of ``x`` held against its plain version on the same inputs, in the
    model's dtype and in bf16 (mixed precision), and timed against it."""
    from academicodec_tpu_torch.nn.hifigan import invalidate_packed

    out = {}
    invalidate_packed(model)  # packed operands hold ctypes arrays, which a deep copy does not take
    for dtype in (torch.float32, torch.bfloat16):
        m = model if dtype == torch.float32 else copy.deepcopy(model).to(torch.bfloat16)
        tag = "f32" if dtype == torch.float32 else "bf16"
        for i, (name, args, kwargs, y) in enumerate(_tower_calls(m, x.to(dtype))):
            with torch.no_grad():
                ref = _tower_plain(name, args, kwargs)
                err = (y.float() - ref.float()).abs().max().item()
                limit = TOWER_LIMITS[dtype] * ref.float().abs().max().item()
                fn = getattr(resblock_ops, name)
                ms = time_ms(lambda: fn(*args, **kwargs), iters)
                plain_ms = time_ms(lambda: _tower_plain(name, args, kwargs), 2)
            p = args[1]
            B, C, T = args[0].shape
            post = {} if p.post_weight is None else dict(c_post=p.post_weight.shape[0], kp=p.post_weight.shape[2])
            bound_ms, bound_by = _tower_bound(B, C, T, p.kernel_sizes, p.dilation_sizes, y.element_size(), **post,
                                              peak=PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS)
            key = f"{'k3' if name == 'resblock_tower' else 'k4'}_{i}_{tag}"
            out[key] = dict(shape=list(args[0].shape), max_abs_err=err, limit=limit, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
            print(f"[train_hifi] {name} at {list(args[0].shape)} {tag}: max abs diff {err:.3g} (limit {limit:.3g}), "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not err <= limit:
                raise AssertionError(f"train_hifi: {name} disagrees with its plain version at {list(args[0].shape)}")
    return out


def _hifi_cross_run(trainer, state, x) -> dict:
    """One step; its losses, every gradient leaf (G and D), the codes and wavs of
    both of its generator forwards and the spectral norm's new ``u``, on the CPU."""
    codes = []
    hook = state.generator.quantizer.register_forward_hook(lambda m, a, out: codes.append(out[2].detach().cpu()))
    try:
        _counts, wavs, (state, metrics) = _watch_gen(trainer, lambda: trainer.train_step(state, x))
    finally:
        hook.remove()
    grads = {f"g.{n}": p.grad.float().cpu() for n, p in state.generator.named_parameters()}
    grads.update({f"d.{n}": p.grad.float().cpu() for n, p in state.discriminators.named_parameters()})
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads, codes=codes, wavs=wavs,
                u=[u.float().cpu() for u in state.discriminators.spectral_u()])


def _hifi_cross_compare(card: dict, cpu: dict, limits: dict, noise: dict) -> tuple:
    """``(passes, comparison)`` of a card step against the CPU's. A gradient leaf
    passes within ``grad_rel`` of its scale (TRAIN_CROSS_LIMITS' rule) or within
    ``noise_factor`` times ``noise``, its difference between two CPU steps of
    other reduction orders (the f32 noise of a cancelling sum)."""
    out = _grad_compare(card["grads"], cpu["grads"])
    grad_rel, diff = out.pop("grad_rel"), out.pop("grad_diff")
    over = {n: (grad_rel[n], diff[n] / max(noise[n], 1e-30)) for n in grad_rel if grad_rel[n] > limits["grad_rel"]}
    out["grad_leaves_over_rule"] = over  # leaf: (diff / scale, diff / f32 noise)
    loss_rel = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["metrics"].items()}
    out.update(loss_max_rel_diff=max(loss_rel.values()), loss_rel_diff=loss_rel,
               codes_differ=sum(int((a != b).sum()) for a, b in zip(card["codes"], cpu["codes"])),
               distinct_codes=int(torch.unique(cpu["codes"][0]).numel()),
               u_max_abs_diff=max((a - b).abs().max().item() for a, b in zip(card["u"], cpu["u"])),
               wav_rel_diff={phase: max((a - b).abs().max().item() / b.abs().max().item()
                                        for a, b in zip(card["wavs"][phase], w)) for phase, w in cpu["wavs"].items()})
    ok = (out["loss_max_rel_diff"] <= limits["loss_rtol"]
          and all(by_noise <= limits["noise_factor"] for _rel, by_noise in over.values())
          and max(out["wav_rel_diff"].values()) <= limits["wav_rel"]
          and out["codes_differ"] == 0 and out["distinct_codes"] > MIN_DISTINCT_TOKENS
          and out["u_max_abs_diff"] <= limits["u_atol"])
    return ok, out


def _hifi_train_cross(device, batch=4, samples=6400, model=HIFI_CROSS_MODEL, discs=HIFI_CROSS_DISCS,
                      limits=HIFI_CROSS_LIMITS) -> dict:
    """A reduced-width HiFi-Codec trainer on the card and on the CPU, f32 (TF32
    off), lr 0, from one state (the CPU's, codebooks spread over the batch's
    latents, the gain of its last conv raised so that its wav has the input's
    std, as a trained generator's has, where the N(0, 0.01^2) init leaves it
    far quieter and the D phase's fake pass blind to the generator)
    loaded by both: one step on each, held to ``limits``: every loss,
    every gradient leaf of both phases (the scale rule, or 4x its f32 noise:
    two CPU thread counts, the card with and without cuDNN), the codes and wavs of both generator
    forwards (the D phase's on K3/K4), the spectral norm's new ``u``. Controls,
    each of which must fail that check: K3's output off by a relative 1e-2
    (every launch of the D phase's forward), and a ``u`` that advances twice
    where it should advance once."""
    from academicodec_tpu_torch.nn import conv as nn_conv
    from academicodec_tpu_torch.nn import hifigan as nn_hifigan
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig, HiFiCodecTrainer

    cfg = HiFiCodecTrainConfig(model=hifi_recipe(**model)[0], **discs, learning_rate=0.0)
    card_tr, cpu_tr = HiFiCodecTrainer(cfg, device=device), HiFiCodecTrainer(cfg, device="cpu")
    cpu_state = cpu_tr.init_state(7)
    x = seeded_wav(batch, samples, "cpu", seed=7)
    vqvae = cpu_state.generator
    spread_codebooks(vqvae, latent_frames(vqvae, x), seed=7)
    with torch.no_grad():
        vqvae.generator.conv_post.weight_g.mul_(x.std() / vqvae(x)[0].std())
    start = copy.deepcopy(cpu_state.state_dict())
    card_state = card_tr.init_state(7)
    card_state.load_state_dict(start)
    cpu = _hifi_cross_run(cpu_tr, cpu_state, x)
    threads = torch.get_num_threads()
    torch.set_num_threads(2 if threads != 2 else 1)
    try:
        cpu_state.load_state_dict(start)
        other = _hifi_cross_run(cpu_tr, cpu_state, x)
    finally:
        torch.set_num_threads(threads)
    reset_launches()
    card = _hifi_cross_run(card_tr, card_state, x)
    launches = read_launches()
    card_state.load_state_dict(start)
    with torch.backends.cudnn.flags(enabled=False):  # PyTorch's own convs: other conv algorithms on the card
        native = _hifi_cross_run(card_tr, card_state, x)
    noise = {n: max((other["grads"][n] - g).abs().max().item(), (native["grads"][n] - card["grads"][n]).abs().max().item())
             for n, g in cpu["grads"].items()}
    ok, out = _hifi_cross_compare(card, cpu, limits, noise)
    _, cpu_vs_cpu = _hifi_cross_compare(other, cpu, limits, noise)
    out["cpu_threads_control"] = {k: cpu_vs_cpu[k] for k in ("loss_max_rel_diff", "grad_max_rel_diff",
                                                              "grad_worst_leaves", "wav_rel_diff")}
    out.update(limits=limits, launches=launches, expected=fused_stage_counts(cfg.model))
    print(f"[train_hifi] card vs CPU at generator {model['upsample_initial_channel']} and encoder "
          f"{model['encoder_base_channels']} channels, {batch} x {samples} samples, f32, lr 0: losses max rel diff "
          f"{out['loss_max_rel_diff']:.3g} (limit {limits['loss_rtol']}), {out['grad_leaves']} gradient leaves max "
          f"diff {out['grad_max_rel_diff']:.3g} of their scale (limit {limits['grad_rel']}; worst "
          f"{out['grad_worst_leaves']}; of their own max |g| {out['grad_max_rel_diff_own']:.3g}), codes differ "
          f"{out['codes_differ']} ({out['distinct_codes']} distinct, floor {MIN_DISTINCT_TOKENS}), u max abs diff "
          f"{out['u_max_abs_diff']:.3g} (limit {limits['u_atol']}), wavs of the D and G phases' forwards "
          f"{out['wav_rel_diff']} of their max (limit {limits['wav_rel']}); K3/K4 launches {launches}; leaves over "
          f"the scale rule (diff / scale, diff / f32 noise; limit {limits['noise_factor']} x noise): "
          f"{out['grad_leaves_over_rule']}; the CPU on {2 if threads != 2 else 1} threads against the CPU: "
          f"{out['cpu_threads_control']}")
    on_card = torch.device(device).type == "cuda"
    if not ok or (on_card and launches != {**{k: 0 for k in launches}, **out["expected"]}):
        raise AssertionError(f"train_hifi: the card's step disagrees with the CPU's: {out}")
    tower, normalize = nn_hifigan.resblock_tower, nn_conv.spectral_normalize

    def k3_off(*args, **kwargs):
        return tower(*args, **kwargs) * (1 + 1e-2)

    def u_twice(w, u, advance):
        if advance:
            normalize(w, u, True)
        return normalize(w, u, advance)

    controls = {}
    for tag, target, name, fault in (("k3_off_1e-2", nn_hifigan, "resblock_tower", k3_off),
                                     ("u_advances_twice", nn_conv, "spectral_normalize", u_twice)):
        card_state.load_state_dict(start)
        original = getattr(target, name)
        setattr(target, name, fault)
        try:
            bad = _hifi_cross_run(card_tr, card_state, x)
        finally:
            setattr(target, name, original)
        bad_ok, cmp = _hifi_cross_compare(bad, cpu, limits, noise)
        controls[tag] = dict(caught=not bad_ok, loss_max_rel_diff=cmp["loss_max_rel_diff"],
                             grad_max_rel_diff=cmp["grad_max_rel_diff"], codes_differ=cmp["codes_differ"],
                             u_max_abs_diff=cmp["u_max_abs_diff"], wav_rel_diff=cmp["wav_rel_diff"])
    out["controls"] = controls
    print(f"[train_hifi] controls of the step: {controls}")
    if not all(c["caught"] for c in controls.values()):
        raise AssertionError(f"train_hifi: a fault passed the card-vs-CPU step check: {controls}")
    return out


def _hifi_train_cli(device, n_files=4, file_seconds=1.0, model=HIFI_CROSS_MODEL, batch=2, segment=8000) -> dict:
    """``cli.train_hificodec`` end to end at a reduced width with the debug-sized
    discriminators' config: one epoch with a state written every step, a resume
    for a second epoch, then ``cli.extract_tokens --model_path`` on the newest
    state, whose tokens must equal the state's ``VQVAE.encode``."""
    import os
    import tempfile

    from academicodec_tpu_torch.cli import extract_tokens as extract_cli
    from academicodec_tpu_torch.cli import train_hificodec
    from academicodec_tpu_torch.data.wavio import write_wav
    from academicodec_tpu_torch.models.hificodec import VQVAE
    from academicodec_tpu_torch.utils.checkpoint import checkpoint_step, load_checkpoint, scan_checkpoint

    cfg, raw = hifi_recipe(**model)
    raw = {**raw, **model, "segment_size": segment}
    sr = cfg.sampling_rate
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "wavs"), os.path.join(tmp, "ckpt")
        os.makedirs(data)
        for i in range(n_files):
            write_wav(os.path.join(data, f"w{i}.wav"), (rng.standard_normal(int(file_seconds * sr)) * 0.1).astype(
                np.float32), sr)
        config = os.path.join(tmp, "config.json")
        with open(config, "w") as fh:
            json.dump(raw, fh)
        argv = ["--config", config, "--input_training_file", data, "--input_validation_file", data,
                "--checkpoint_path", out, "--batch_size", str(batch), "--training_epochs", "1",
                "--checkpoint_interval", "1", "--validation_interval", "2", "--stdout_interval", "1",
                "--device", str(device)]
        t0 = time.perf_counter()
        train_hificodec.main(argv)
        first = scan_checkpoint(out, "state")
        argv[argv.index("--training_epochs") + 1] = "2"
        train_hificodec.main(argv)
        wall_s = time.perf_counter() - t0
        latest = scan_checkpoint(out, "state")
        log = open(os.path.join(out, "logs", "log.txt")).read()
        tokens = os.path.join(tmp, "tokens.npz")
        extract_cli.main(["--config", config, "--model_path", latest, "--input", data, "--outputdir",
                          os.path.join(tmp, "syn"), "--tokens_out", tokens, "--device", str(device)])
        got = np.load(tokens)["w0"]
        codec = VQVAE(cfg, device=device)
        codec.load_reference(load_checkpoint(latest))
        from academicodec_tpu_torch.data.wavio import read_wav
        want = codec.encode(torch.from_numpy(read_wav(os.path.join(data, "w0.wav"))[0][None])).cpu().numpy()
        steps = n_files // batch
        result = dict(steps_after_one_epoch=checkpoint_step(first), steps_after_resume=checkpoint_step(latest),
                      wall_s=wall_s, validated="validation/mel_spec_error" in log, resumed="resumed from" in log,
                      tokens_shape=list(got.shape), tokens_equal=bool(np.array_equal(got, want)),
                      config_copied=os.path.exists(os.path.join(out, "config.json")))
    print(f"[train_hifi] cli: {result}")
    if not (result["steps_after_one_epoch"] == steps and result["steps_after_resume"] > steps and result["resumed"]
            and result["validated"] and result["tokens_equal"] and result["config_copied"]):
        raise AssertionError(f"train_hifi cli: {result}")
    return result


def phase_train_hifi(device="cuda", batch=10, samples=16000, steps=8, mp_steps=3, profile_steps=5, model=None,
                     discs=HIFI_TRAIN_DISCS, cross_batch=4, cross_samples=6400, cross_model=HIFI_CROSS_MODEL,
                     cross_discs=HIFI_CROSS_DISCS, cli_model=HIFI_CROSS_MODEL, cli_files=4, cli_segment=8000) -> dict:
    """The HiFi-Codec GAN trainer through ``train.hificodec.HiFiCodecTrainer``
    (what ``cli.train_hificodec`` calls), hificodec_24k_320d's recipe at full
    width (``model`` overrides it) with the reference discriminators, ``batch``
    x ``samples`` (the reference's batch 80 over its 8 GPUs, 16000-sample
    segments): f32 (TF32 off) for a first step and ``steps`` timed ones, K3/K4
    launches by phase (the D phase's no-grad forward: one a fused stage; the G
    phase: 0) and in ``eval_step``; the idle share over ``profile_steps`` steps;
    K3/K4 at the trainer's shapes against their plain versions; mixed
    precision for ``mp_steps``. Then the card against the CPU
    (:func:`_hifi_train_cross`) and the CLI (:func:`_hifi_train_cli`)."""
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig, HiFiCodecTrainer

    on_card = torch.device(device).type == "cuda"
    cfg = HiFiCodecTrainConfig(model=hifi_recipe(**(model or {}))[0], **discs)
    trainer = HiFiCodecTrainer(cfg, device=device)
    result = {}
    f32 = _hifi_train_run("train_hifi", trainer, batch, samples, steps)
    state, x = f32.pop("state"), f32.pop("x")
    if on_card:
        def run_one():
            nonlocal state
            state, _m = trainer.train_step(state, x)

        if profile_steps:
            f32.update(_profile_steps(run_one, profile_steps))
            print("[train_hifi] device ms a step by kernel, top 12: "
                  + "; ".join(f"{k[:60]} {v:.2f}" for k, v in f32["top_device_ms_per_step"].items()))
            print(f"[train_hifi] profiled {profile_steps} steps: wall {f32['profiled_wall_ms']:.1f} ms, device busy "
                  f"{f32['device_busy_ms']} ms, idle share {f32['idle_share']}, "
                  f"{f32['device_ops_per_step']:.0f} device operations a step ({nvidia_smi()})")
        result["towers"] = _hifi_train_towers(state.generator, x)
    del state, x
    result["f32"] = f32
    mp = _hifi_train_run("train_hifi_mp", HiFiCodecTrainer(
        HiFiCodecTrainConfig(model=cfg.model, **discs, mixed_precision=True), device=device), batch, samples, mp_steps)
    mp.pop("state"), mp.pop("x")
    result["mixed_precision"] = mp
    result["cross"] = _hifi_train_cross(device, batch=cross_batch, samples=cross_samples, model=cross_model,
                                        discs=cross_discs)
    result["cli"] = _hifi_train_cli(device, n_files=cli_files, model=cli_model, segment=cli_segment)
    return result


def _lm_tokens(device, batch, seconds, preset, **overrides):
    """The flagship codec (codebooks spread over the first batch's latents) and a
    tokenizer of ``batch`` x ``seconds`` seeded noise, as ``cli.train_lm`` tokenizes:
    ``SoundStream.encode`` at the top bandwidth -> codes ``[B, frames, n_q]``."""
    model = load_codec(preset, device=device, **overrides)
    wav = seeded_wav(batch, int(round(seconds * model.sample_rate)), "cpu", seed=9)
    spread_codebooks(model, latent_frames(model, wav))
    bw = model.target_bandwidths[-1]

    def tokenize(w):
        return model.encode(w, target_bw=bw).permute(1, 2, 0).long()

    return model, wav, tokenize


def _lm_train_cli(device, model, width: dict, n_files=4, seconds=1.0, steps=4, batch=2, lm_width=LM_WIDTH) -> dict:
    """``cli.train_lm`` for ``steps`` steps on ``model``'s tokens (its weights saved
    as a ``.pth``), then ``cli.compress --lm`` on one file with the LM it wrote:
    the blob must decode to the raw blob's tokens; and the written LM codes those
    tokens (``compress_tokens_with_lm``) and decodes them back exactly."""
    import os
    import tempfile

    from academicodec_tpu_torch.cli import compress as compress_cli
    from academicodec_tpu_torch.cli import train_lm
    from academicodec_tpu_torch.data.wavio import write_wav
    from academicodec_tpu_torch.models.lm import load_lm

    sr = model.sample_rate
    flags = ["--sr", str(sr), "--ratios", *map(str, model.ratios),
             "--target_bandwidths", *map(str, model.target_bandwidths), "--n_filters", str(width["n_filters"]),
             "--dimension", str(width["dimension"]), "--bins", str(model.bins), "--device", str(device)]
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        data, lm_dir = os.path.join(tmp, "wavs"), os.path.join(tmp, "lm")
        os.makedirs(data)
        for i in range(n_files):
            write_wav(os.path.join(data, f"w{i}.wav"), (rng.standard_normal(int(seconds * sr)) * 0.1).astype(
                np.float32), sr)
        ckpt = os.path.join(tmp, "codec.pth")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        t0 = time.perf_counter()
        train_lm.main(["--train_data_path", data, "--resume_path", ckpt, *flags, "--target_bw",
                       str(model.target_bandwidths[-1]), "--lm_dim", str(lm_width["dim"]), "--lm_heads",
                       str(lm_width["num_heads"]), "--lm_layers", str(lm_width["num_layers"]), "--steps", str(steps),
                       "--batch_size", str(batch), "--segment_seconds", str(seconds), "--print_freq", "1",
                       "--path", lm_dir])
        wall_s = time.perf_counter() - t0
        one = os.path.join(tmp, "one")
        os.makedirs(one)
        os.link(os.path.join(data, "w0.wav"), os.path.join(one, "w0.wav"))
        base = ["--input", one, "--resume_path", ckpt, *flags, "--target_bw", str(model.target_bandwidths[-1]),
                "--ecdc"]
        compress_cli.main(base + ["--output", os.path.join(tmp, "raw")])
        compress_cli.main(base + ["--output", os.path.join(tmp, "lmout"), "--lm", lm_dir])
        raw = open(os.path.join(tmp, "raw", "w0.ecdc"), "rb").read()
        blob = open(os.path.join(tmp, "lmout", "w0.ecdc"), "rb").read()
        lm, meta = load_lm(lm_dir, device=device)
        codes = decompress_tokens(raw)[0]
        lm_blob = compress_tokens_with_lm(lm, codes)
        result = dict(steps=steps, wall_s=wall_s, meta=meta, lm_chosen=binary.read_ecdc_header(io.BytesIO(blob)).get("lm", False),
                      cli_blob_decodes=bool(np.array_equal(decompress_tokens(blob, lm=lm)[0], codes)),
                      lm_blob_bytes=len(lm_blob), raw_blob_bytes=len(raw),
                      lm_blob_decodes=bool(np.array_equal(decompress_tokens_with_lm(lm, lm_blob)[0], codes)))
    print(f"[train_lm] cli: {result}")
    if not (result["cli_blob_decodes"] and result["lm_blob_decodes"] and meta.get("family") == "encodec"):
        raise AssertionError(f"train_lm cli: {result}")
    return result


def phase_train_lm(device="cuda", batch=16, seconds=1.0, steps=8, lm_width=LM_WIDTH, preset=FLAGSHIP,
                   cli_files=4, cli_steps=4, **overrides) -> dict:
    """The token-LM trainer (``train.lm.LMTrainer``, what ``cli.train_lm`` calls)
    at ``lm_width`` on Encodec_24k_240d's tokens at its top bandwidth (12 kbps,
    12 streams), ``batch`` x ``seconds``: each step tokenizes the batch (K1 + K2)
    and takes one Adam step; the LM step's median ms of ``steps`` (CUDA events),
    tokens per s, the tokenizer's launches a step. Then the CLI
    (:func:`_lm_train_cli`)."""
    from academicodec_tpu_torch.train.lm import LMTrainConfig, LMTrainer

    on_card = torch.device(device).type == "cuda"
    model, wav, tokenize = _lm_tokens(device, batch, seconds, preset, **overrides)
    codes = tokenize(wav)
    trainer = LMTrainer(LMTrainConfig(n_q=codes.shape[2], bins=model.bins, **lm_width), device=device)
    state = trainer.init_state(0)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []

    def step():
        nonlocal state
        state, metrics = trainer.train_step(state, codes)
        losses.append({k: float(v) for k, v in metrics.items()})

    reset_launches()
    with torch.no_grad():
        codes = tokenize(wav)
    _train_seconds(step, on_card)
    launches = {k: read_launches()[k] for k in ("rvq_encode", "lstm2")}
    for _ in range(steps):
        times.append(_train_seconds(step, on_card))
    expected = {"rvq_encode": 1 if on_card else 0, "lstm2": k2_slstms(model.encoder) if on_card else 0}
    ms = statistics.median(times) * 1e3
    out = dict(step_ms_median=ms, step_ms_max=max(times) * 1e3, tokens_per_s=codes.numel() / (ms / 1e3),
               codes_shape=list(codes.shape), launches_step=launches, expected_step=expected,
               losses_first=losses[0], losses_last=losses[-1],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None)
    print(f"[train_lm] LM {lm_width} on {preset} tokens {list(codes.shape)}: step median {ms:.2f} ms (max "
          f"{out['step_ms_max']:.2f}) of {steps}, {out['tokens_per_s']:.0f} tokens per s, tokenizer launches a step "
          f"{launches} (expected {expected}), bits per token {losses[0]['bits_per_token']:.3f} -> "
          f"{losses[-1]['bits_per_token']:.3f}, peak memory {out['peak_mem_gib']}")
    if launches != expected or not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"train_lm: launches {launches} (expected {expected}), losses {losses}")
    if not losses[-1]["ce_loss"] < losses[0]["ce_loss"]:
        raise AssertionError(f"train_lm: the loss did not fall over {steps} steps on one batch: {losses}")
    from academicodec_tpu_torch.models.presets import SOUNDSTREAM_PRESETS

    width = {**SOUNDSTREAM_PRESETS[preset], **overrides}
    out["cli"] = _lm_train_cli(device, model, width, n_files=cli_files, steps=cli_steps, lm_width=lm_width)
    return out


# ---------------------------------------------------------------------------
# ROADMAP.md Queue 3 item 3: where batched and one-file-a-call extraction part

def extract_corpus(device, n_files=8, min_seconds=3.0, max_seconds=10.0, preset=HIFI, **overrides):
    """``phase_extract``'s model (codebooks spread over the first file's latent
    frames) and its ``n_files`` seeded wavs of ``min_seconds``-``max_seconds``."""
    model = load_codec(preset, device=device, **overrides)
    sr = model.config.sampling_rate
    rng = np.random.default_rng(11)
    lengths = rng.integers(int(min_seconds * sr), int(max_seconds * sr) + 1, n_files)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]
    spread_codebooks(model, latent_frames(model, torch.from_numpy(wavs[0][None])))
    return model, wavs, lengths


def _encoder_captures(model, run):
    """``run()``'s tokens and every encoder stage's output in call order: the
    first conv, each strided conv's input and output, each wide stage's
    resblocks and GroupNorms, the last conv's input and output."""
    enc = model.encoder
    caps, hooks = [], []

    def out_hook(name):
        return lambda mod, args, out: caps.append((name, out.detach().float()))

    def in_hook(name):
        return lambda mod, args: caps.append((name, args[0].detach().float()))

    named = [("conv_pre", enc.conv_pre), ("conv_post", enc.conv_post)]
    named += [(f"ups.{i}", m) for i, m in enumerate(enc.ups)]
    named += [(f"resblocks.{i}", m) for i, m in enumerate(enc.resblocks)]
    named += [(f"normalize.{i}", m) for i, m in enumerate(enc.normalize)]
    for name, m in named:
        hooks.append(m.register_forward_hook(out_hook(name)))
        if name.startswith("ups") or name == "conv_post":
            hooks.append(m.register_forward_pre_hook(in_hook(name + ".in")))
    try:
        tokens = run()
    finally:
        for h in hooks:
            h.remove()
    return tokens, caps


def _f32_accumulation(self, x, frames):
    """``GroupNormTorch.accumulation`` with f32 statistics on every device, as
    the port had them before its card sums of f32 inputs went to f64."""
    return torch.float32 if frames.mask is not None else None


def phase_extract_groupnorm(device="cuda", bucket_seconds=10.0, iters=5, **extract) -> dict:
    """What f64 GroupNorm statistics cost corpus tokenization: ``phase_extract``
    with ``GroupNormTorch`` as it is (f32 inputs on the card sum in f64) and
    with f32 statistics (:func:`_f32_accumulation`), after a warm-up run,
    in the order f32, f64, f64, f32; for each run the batched run's audio
    seconds per wall second, its peak memory and the token mismatch batched
    vs one file a call. On the card, then, the batched masked encode of the
    same corpus alone in the same order: device ms (CUDA events, mean of
    ``iters``) and peak memory."""
    from academicodec_tpu_torch.nn.hifigan import GroupNormTorch

    f64_accumulation, runs, encodes, shape = GroupNormTorch.accumulation, [], [], None
    order = ("f32", "f64", "f64", "f32")
    try:
        for stats in ("warm-up",) + order:
            GroupNormTorch.accumulation = _f32_accumulation if stats == "f32" else f64_accumulation
            r = phase_extract(device, bucket_seconds=bucket_seconds, **extract)
            runs.append(dict(stats=stats, audio_s_per_s=r.get("audio_seconds_per_wall_second"),
                             peak_mem_gib=r.get("peak_mem_gib"), token_mismatch=r["token_mismatch"]))
        if torch.device(device).type == "cuda":
            corpus = {k: v for k, v in extract.items() if k not in ("int8_min_channels", "lm_width")}
            model, wavs, lengths = extract_corpus(device, **corpus)
            bucket = math.ceil(round(bucket_seconds * model.config.sampling_rate) / model.hop_length) * model.hop_length
            batch = torch.zeros((len(wavs), -(-int(lengths.max()) // bucket) * bucket))
            for i, w in enumerate(wavs):
                batch[i, : len(w)] = torch.from_numpy(w)
            batch, lens, shape = batch.to(model.device), torch.from_numpy(lengths), list(batch.shape)
            for stats in order:
                GroupNormTorch.accumulation = _f32_accumulation if stats == "f32" else f64_accumulation
                with torch.no_grad():
                    model.encode(batch, lengths=lens)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    ms = time_ms(lambda: model.encode(batch, lengths=lens), iters, warmup=0)
                encodes.append(dict(stats=stats, encode_ms=ms, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))
    finally:
        GroupNormTorch.accumulation = f64_accumulation
    print(f"[extract_groupnorm] {json.dumps(runs[1:])}")
    if encodes:
        print(f"[extract_groupnorm] the batched masked encode of {shape}: {json.dumps(encodes)} ({nvidia_smi()})")
    return {"runs": runs[1:], "encodes": encodes}


def _unsegmented(model, caps, lengths, width):
    """Batched captures put back in the padded batch where a wide stage ran on
    its valid frames (``nn/hifigan.Segments``: its resblocks' and GroupNorms'
    outputs are one row ``[1, C, N]``), so that they compare row by row."""
    enc = model.encoder
    L, T, segs = torch.as_tensor(lengths).long(), width, []
    for u, k in enc.ups_cfg:
        L, T = strided_length(L, k, u), strided_length(T, k, u)
        segs.append(Segments(L.tolist(), L, stage_reach(enc.rks, enc.rds), T))
    out = []
    for name, c in caps:
        if name.startswith(("resblocks.", "normalize.")):
            seg = segs[int(name.split(".")[1]) // len(enc.rks)]
            if c.shape[0] != len(L) or c.shape[-1] != seg.T:
                c = seg.scatter(c)
        out.append((name, c))
    return out


def phase_extract_stages(device="cuda", bucket_seconds=10.0, **corpus) -> dict:
    """Each file of ``phase_extract``'s corpus encoded alone at its exact length
    and in the batch padded to whole buckets with its length (the CLI's two
    runs), every encoder stage captured: per stage the largest |batched -
    exact| over the files' valid frames and the first stage that differs for
    a file whose tokens differ. Run with cuDNN's convs and again with cuDNN
    off (PyTorch's own CUDA convs), to tell a per-shape cuDNN algorithm from a
    masked sum of the port's that reads past a length."""
    model, wavs, lengths = extract_corpus(device, **corpus)
    sr, hop = model.config.sampling_rate, model.hop_length
    bucket = math.ceil(round(bucket_seconds * sr) / hop) * hop
    width = -(-int(lengths.max()) // bucket) * bucket
    batch = torch.zeros((len(wavs), width))
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = torch.from_numpy(w)
    result = {}
    for backend in ("cudnn", "native"):
        torch.backends.cudnn.enabled = backend == "cudnn"
        try:
            with torch.no_grad():
                tok_b, cap_b = _encoder_captures(model, lambda: model.encode(batch, lengths=torch.from_numpy(lengths)))
                cap_b = _unsegmented(model, cap_b, lengths, width)
                singles = [_encoder_captures(model, lambda w=w: model.encode(torch.from_numpy(w)[None]))
                           for w in wavs]
        finally:
            torch.backends.cudnn.enabled = True
        stage_diff, first_stage, tokens_differ = {}, {}, {}
        for f, (tok_s, cap_s) in enumerate(singles):
            frames = tok_s.shape[1]
            tokens_differ[f] = int((tok_b[f, :frames] != tok_s[0]).sum())
            if len(cap_s) != len(cap_b):
                raise AssertionError(f"extract stages: {len(cap_s)} captures alone, {len(cap_b)} batched")
            for (name, a), (name_b, b) in zip(cap_s, cap_b):
                t = a.shape[-1]
                d = (b[f, :, :t] - a[0]).abs().max().item() / max(a.abs().max().item(), 1e-30)
                stage_diff[name] = max(stage_diff.get(name, 0.0), d)
                if d > 0 and f not in first_stage:
                    first_stage[f] = name
        differing = [f for f, n in tokens_differ.items() if n]
        result[backend] = dict(tokens_differ=sum(tokens_differ.values()), files_differ=differing,
                               first_stage_that_differs={f: first_stage.get(f) for f in differing},
                               first_stage_any_file=next((n for n, d in stage_diff.items() if d > 0), None),
                               max_rel_diff_by_stage=stage_diff)
        print(f"[extract_stages] {backend}: {sum(tokens_differ.values())} tokens differ (files {differing}); first "
              f"stage that differs for them {result[backend]['first_stage_that_differs']}; per stage the largest "
              f"|batched - exact| / max|exact| over valid frames: "
              + ", ".join(f"{n} {d:.3g}" for n, d in stage_diff.items()))
    return result


# ---------------------------------------------------------------------------
# objective evaluation (cli/evaluate.py) and the native crop loader

# PESQ of an identical pair: raw 4.5 through the P.862.1 (nb) and P.862.2 (wb) mappings
PESQ_IDENTICAL = {"pesq_nb": 4.549, "pesq_wb": 4.644}
MEL_CARD_CPU_RTOL = 1e-4
# first-step losses of a native-fed trainer run against the Python-fed one (the same
# batches and draws; the card's backward sums may part in their last bits)
NATIVE_LOSS_RTOL = 1e-5


def speech_like(n: int, sr: int, seed: int) -> np.ndarray:
    """``n`` samples of tests/test_pesq.py's test signal on a seeded pitch and
    rhythm: a syllabically modulated harmonic tone plus a noise floor, with
    0.25 s of silence at each end; f32."""
    rng = np.random.default_rng(seed)
    pad = sr // 4
    t = np.arange(n - 2 * pad) / sr
    f0 = rng.uniform(100.0, 250.0)
    env = (np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t) ** 2) * (
        np.sin(2 * np.pi * rng.uniform(0.2, 0.5) * t + rng.uniform(0, np.pi)) ** 2)
    x = env * (0.3 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
               + 0.1 * np.sin(2 * np.pi * 4 * f0 * t)) + 0.005 * rng.standard_normal(len(t))
    return np.concatenate([np.zeros(pad), x, np.zeros(pad)]).astype(np.float32)


def eval_corpus(directory: str, n_files: int, min_seconds: float, max_seconds: float, sr: int,
                seed: int = 12) -> np.ndarray:
    """``n_files`` speech-like wavs of ``min_seconds``-``max_seconds`` written to
    ``directory`` as ``e<i>.wav``, ``i`` zero-padded so that the names sort in
    the order they were drawn; their lengths."""
    from academicodec_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    lengths = rng.integers(int(min_seconds * sr), int(max_seconds * sr) + 1, n_files)
    os.makedirs(directory, exist_ok=True)
    digits = len(str(n_files - 1))
    for i, n in enumerate(lengths):
        write_wav(os.path.join(directory, f"e{i:0{digits}d}.wav"), speech_like(int(n), sr, seed + i), sr)
    return lengths


def _check_report(tag: str, report: dict, n_files: int) -> None:
    """Every metric of every row finite, or null (NaN) and counted in ``skipped``."""
    rows = report["per_file"]
    if len(rows) != n_files:
        raise AssertionError(f"evaluate {tag}: {len(rows)} rows for {n_files} files")
    for k, skipped in report["skipped"].items():
        vals = [r.get(k) for r in rows if k in r]
        nulls = sum(v is None for v in vals)
        if nulls != skipped or not all(math.isfinite(v) for v in vals if v is not None):
            raise AssertionError(f"evaluate {tag}: {k} has {nulls} null rows, {skipped} skipped: {vals}")


def phase_evaluate(device="cuda", n_files=8, min_seconds=3.0, max_seconds=10.0, bucket_seconds=10.0,
                   preset=FLAGSHIP, hifi_preset=HIFI, overrides=None, hifi_overrides=None) -> dict:
    """Objective evaluation of both codecs through the port's CLIs: ``n_files``
    seeded speech-like wavs of ``min_seconds``-``max_seconds`` at 24 kHz go
    through ``cli.compress`` (Encodec_24k_240d, ECDC on, one batch of
    ``n_files``; K1, K2) and ``cli.extract_tokens`` (hificodec_24k_320d,
    batched with lengths, synthesis on; K3, K4), each model seeded and its
    codebooks spread over the first file's latent frames, the launch counts
    read around each CLI; then ``cli.evaluate --estoi --json_out`` scores
    each output directory against the inputs. Checks: the identical pair's
    anchors (PESQ nb 4.549 and wb 4.644 within 1e-3, STOI > 0.99), every
    metric finite or null and counted in ``skipped``, the CLI's mel
    distances (on the card) within ``MEL_CARD_CPU_RTOL`` of the CPU's, the
    launches. Prints the CLI's seconds and, from each file's metrics run
    again one at a time, the host seconds of PESQ and STOI per file and the
    mel distance's device ms (CUDA events around the call)."""
    import dataclasses
    import tempfile

    from academicodec_tpu_torch.cli import compress as compress_cli
    from academicodec_tpu_torch.cli import evaluate as evaluate_cli
    from academicodec_tpu_torch.cli import extract_tokens
    from academicodec_tpu_torch.data.wavio import read_wav
    from academicodec_tpu_torch.eval import metrics
    from academicodec_tpu_torch.eval.stoi import stoi_and_estoi
    from academicodec_tpu_torch.models.presets import SOUNDSTREAM_PRESETS

    on_card = torch.device(device).type == "cuda"
    width = {**SOUNDSTREAM_PRESETS[preset], **(overrides or {})}
    sr = width["sample_rate"]

    def launches_of(run):
        if on_card:
            torch.cuda.synchronize()
        reset_launches()
        run()
        if on_card:
            torch.cuda.synchronize()
        return read_launches()

    result = {"files": n_files}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wavs = os.path.join(tmp, "wavs")
        lengths = eval_corpus(wavs, n_files, min_seconds, max_seconds, sr)
        names = sorted(os.listdir(wavs))  # the CLI's row order
        first = torch.from_numpy(read_wav(os.path.join(wavs, names[0]))[0][None])
        result["audio_seconds"] = float(lengths.sum()) / sr

        model = load_codec(preset, device=device, **(overrides or {}))
        spread_codebooks(model, latent_frames(model, first))
        pth = os.path.join(tmp, "encodec.pth")
        torch.save(model.state_dict(), pth)
        expected = {"encodec": {"rvq_encode": 1, "lstm2": k2_slstms(model), "resblock_tower": 0,
                                "resblock_tower_gn": 0}}
        del model
        outputs = {"encodec": os.path.join(tmp, "encodec_out"), "hificodec": os.path.join(tmp, "hificodec_out")}
        launches = {"encodec": launches_of(lambda: compress_cli.main([
            "--input", wavs, "--output", outputs["encodec"], "--resume_path", pth, "--sr", str(sr),
            "--ratios", *map(str, width["ratios"]), "--target_bandwidths", *map(str, width["target_bandwidths"]),
            "--target_bw", str(width["target_bandwidths"][-1]), "--n_filters", str(width["n_filters"]),
            "--dimension", str(width["dimension"]), "--bins", str(width.get("bins", 1024)), "--ecdc",
            "--bucket_seconds", str(bucket_seconds), "--batch_files", str(n_files), "--device", str(device)]))}

        hifi = load_codec(hifi_preset, device=device, **(hifi_overrides or {}))
        if hifi.config.sampling_rate != sr:
            raise ValueError(f"{hifi_preset} runs at {hifi.config.sampling_rate} Hz, the corpus at {sr}")
        spread_codebooks(hifi, latent_frames(hifi, first))
        ckpt, config = os.path.join(tmp, "g_00000000"), os.path.join(tmp, "config.json")
        torch.save({part: getattr(hifi, part).state_dict() for part in ("encoder", "generator", "quantizer")}, ckpt)
        with open(config, "w") as fh:
            json.dump(dataclasses.asdict(hifi.config), fh)
        expected["hificodec"] = {"rvq_encode": 0, "lstm2": 0, **fused_stage_counts(hifi.config)}
        del hifi
        launches["hificodec"] = launches_of(lambda: extract_tokens.main([
            "--config", config, "--model_path", ckpt, "--input", wavs, "--outputdir", outputs["hificodec"],
            "--tokens_out", os.path.join(tmp, "tokens.npz"), "--batch_files", str(n_files),
            "--bucket_seconds", str(bucket_seconds), "--device", str(device)]))
        if not on_card:
            expected = {tag: {k: 0 for k in e} for tag, e in expected.items()}

        identical = metrics.evaluate_pair(first[0].numpy(), first[0].numpy(), sr, estoi=True, device=device)
        result["identical"] = identical
        for tag, out_dir in outputs.items():
            json_out = os.path.join(tmp, f"{tag}.json")
            t0 = time.perf_counter()
            evaluate_cli.main(["--ref_dir", wavs, "--deg_dir", out_dir, "--sr", str(sr), "--estoi",
                               "--json_out", json_out, "--device", str(device)])
            cli_s = time.perf_counter() - t0
            with open(json_out) as fh:
                report = json.load(fh)
            _check_report(tag, report, n_files)
            # each file's metrics again, one at a time: their host seconds, the mel
            # distance's device time, and the CLI's mel distance against the CPU's
            pesq_s, stoi_s, mel_s, mel_err = [], [], [], 0.0
            for name, row in zip(names, report["per_file"]):
                ref, deg = (read_wav(os.path.join(d, name), sr=sr)[0] for d in (wavs, out_dir))
                n = min(len(ref), len(deg))
                pesq_s.append(_train_seconds(lambda: metrics.pesq_score(deg, ref, sr), False))
                stoi_s.append(_train_seconds(lambda: stoi_and_estoi(ref[:n], deg[:n], sr), False))
                mel_s.append(_train_seconds(lambda: metrics.mel_distance(deg, ref, sr, device=device), on_card))
                cpu = metrics.mel_distance(deg, ref, sr, device="cpu")
                mel_err = max(mel_err, abs(row["mel_l1"] - cpu) / max(abs(cpu), 1e-12))
            audio_s = float(lengths.sum()) / sr
            row = result[tag] = dict(
                mean=report["mean"], skipped=report["skipped"], launches=launches[tag], expected=expected[tag],
                cli_s=cli_s, pesq_host_s_per_file=statistics.mean(pesq_s), stoi_host_s_per_file=statistics.mean(stoi_s),
                pesq_host_s_per_10s_audio=sum(pesq_s) / audio_s * 10, stoi_host_s_per_10s_audio=sum(stoi_s) / audio_s * 10,
                mel_ms_per_file=statistics.mean(mel_s) * 1e3, mel_card_vs_cpu_rel=mel_err,
            )
            print(f"[evaluate] {tag}: launches of the roundtrip {launches[tag]} (expected {expected[tag]}); "
                  f"means {json.dumps(report['mean'])}, skipped {json.dumps(report['skipped'])}")
            print(f"[evaluate] {tag}: cli.evaluate {cli_s:.3f} s for {n_files} files ({audio_s:.2f} s of audio): "
                  f"PESQ nb+wb {row['pesq_host_s_per_file']:.3f} host s a file "
                  f"({row['pesq_host_s_per_10s_audio']:.3f} per 10 s), STOI+ESTOI {row['stoi_host_s_per_file']:.3f} "
                  f"({row['stoi_host_s_per_10s_audio']:.3f} per 10 s), mel distance {row['mel_ms_per_file']:.3f} "
                  f"ms a file ({'CUDA events' if on_card else 'host clock'}), card vs CPU {mel_err:.3g} (limit "
                  f"{MEL_CARD_CPU_RTOL}){f' ({nvidia_smi()})' if on_card else ''}")
            if launches[tag] != expected[tag] or mel_err > MEL_CARD_CPU_RTOL:
                raise AssertionError(f"evaluate {tag}: launches {launches[tag]} (expected {expected[tag]}), "
                                     f"mel card vs CPU {mel_err:.3g}")
    result["wall_s"] = time.perf_counter() - t_phase
    print(f"[evaluate] identical pair ({names[0]}, {first.shape[1] / sr:.2f} s): {json.dumps(identical)}; the phase "
          f"{result['wall_s']:.1f} s")
    if not (all(abs(identical[k] - v) <= 1e-3 for k, v in PESQ_IDENTICAL.items()) and identical["stoi"] > 0.99):
        raise AssertionError(f"evaluate: the identical pair's anchors {identical}")
    return result


@contextlib.contextmanager
def recorded_steps(trainer_cls):
    """Within: each ``trainer_cls.train_step`` call recorded, in order, as a dict
    of its batch (host f32), metrics (floats), kernel launches (the counts set
    to 0 just before the step and read just after), ``inited`` (for a trainer
    whose generator has a codebook quantizer, whether every layer was inited
    before the step; else None), its host seconds (synchronized at both ends)
    and, after the first, the host seconds since the previous step ended
    (``wait_s``: the caller's loop, the next batch's load among it)."""
    steps = []
    train_step = trainer_cls.train_step

    def recorded(self, state, x, *args, **kwargs):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        vq = getattr(state.generator.quantizer, "vq", None)
        rec = {"batch": x.detach().cpu().numpy() if torch.is_tensor(x) else np.array(x),
               "inited": all(vq.inited_layers()) if vq is not None else None,
               "wait_s": t0 - steps[-1]["end"] if steps else None}
        steps.append(rec)
        reset_launches()
        state, metrics = train_step(self, state, x, *args, **kwargs)
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        rec["launches"] = read_launches()
        rec["end"] = time.perf_counter()
        rec["s"] = rec["end"] - t0
        return state, metrics

    trainer_cls.train_step = recorded
    try:
        yield steps
    finally:
        trainer_cls.train_step = train_step


NATIVE_PAIR_ORDER = ("python", "native", "native", "python")


def _native_pair(tag, trainer_cls, run, steady: dict) -> dict:
    """``run(native)`` fed as ``NATIVE_PAIR_ORDER`` says, each step recorded:
    every run's batches bit-identical to the first run's and its launches
    equal to the first run's step for step, every loss finite, each run's
    first-step losses within ``NATIVE_LOSS_RTOL`` of the first run's. A
    steady step (one before which every codebook layer is inited, or any
    step of a trainer without codebook init) must launch ``steady``, and at
    least one must occur. The steady steps after each run's first are timed,
    by feed."""
    runs = []
    for feed in NATIVE_PAIR_ORDER:
        with recorded_steps(trainer_cls) as steps:
            run(feed == "native")
        runs.append(steps)
    ref = runs[0]
    first = ref[0]["metrics"]
    rel = max(abs(r[0]["metrics"][k] - v) / max(abs(v), 1e-12) for r in runs[1:] for k, v in first.items())
    steady_at = [i for i, s in enumerate(ref) if s["inited"] is not False]
    out = dict(
        steps=len(ref), order=NATIVE_PAIR_ORDER,
        batches_equal=all(len(r) == len(ref) and all(np.array_equal(a["batch"], b["batch"]) for a, b in zip(ref, r))
                          for r in runs[1:]),
        finite=all(math.isfinite(v) for r in runs for s in r for v in s["metrics"].values()),
        first_step_loss_rel=rel,
        launches_steps=[s["launches"] for s in ref],
        launches_equal=all([s["launches"] for s in r] == [s["launches"] for s in ref] for r in runs[1:]),
        steady_steps=steady_at, steady_launches=steady,
        steady_launches_equal=bool(steady_at) and all(
            {k: ref[i]["launches"][k] for k in steady} == steady for i in steady_at),
        losses_first_step=runs[1][0]["metrics"])
    for feed in ("python", "native"):
        mine = [r for r, f in zip(runs, NATIVE_PAIR_ORDER) if f == feed]
        out[f"steady_step_ms_{feed}"] = [r[i]["s"] * 1e3 for r in mine for i in steady_at if i > 0]
        out[f"wait_ms_{feed}"] = [s["wait_s"] * 1e3 for r in mine for s in r[1:]]
    ms = ", ".join(f"{k} " + " ".join(f"{v:.1f}" for v in out[k])
                   for k in ("steady_step_ms_python", "steady_step_ms_native", "wait_ms_python", "wait_ms_native"))
    print(f"[native_loader] {tag}: {out['steps']} steps a run, fed {' '.join(NATIVE_PAIR_ORDER)}: batches "
          f"bit-identical {out['batches_equal']}, launches equal {out['launches_equal']}, losses finite "
          f"{out['finite']}, first-step losses {rel:.3g} apart (limit {NATIVE_LOSS_RTOL}); launches a step "
          f"{out['launches_steps']}, steady steps {steady_at} launch {steady}: {out['steady_launches_equal']}; "
          f"host ms: {ms}")
    if not (out["steps"] >= 2 and out["batches_equal"] and out["launches_equal"] and out["finite"]
            and rel <= NATIVE_LOSS_RTOL and out["steady_launches_equal"] and out["steady_step_ms_native"]):
        raise AssertionError(f"native loader {tag}: {out}")
    return out


def phase_native_loader(steady: dict, device="cuda", n_files=32, file_seconds=3.0, workers=8, rate_batches=300,
                        width=TRAIN_RECIPE, batch=8, segment_seconds=1.0, hifi_model=None, hifi_batch=8,
                        hifi_segment=16000) -> dict:
    """The C++ crop loader (``data/native_loader.py``): the library built from
    ``native/wavloader.cpp``; on ``n_files`` seeded wavs of ``file_seconds`` at
    24 kHz one epoch bit-identical to ``batch_iterator`` (without and with p=0.3
    mixtures); batches a second at ``workers`` threads against the Python
    pipeline at the segment and batch of ``phase_train`` and of
    ``phase_train_hifi``: ``rate_batches`` batches after each iterator's set-up
    and first batch, fed native, Python, Python, native; then
    ``cli.train_encodec`` (``width``, the debug discriminators, ``batch`` x
    ``segment_seconds``) and ``cli.train_hificodec`` (hificodec_24k_320d's
    recipe with ``hifi_model`` overrides, the reference discriminators,
    ``hifi_batch`` x ``hifi_segment``) for one epoch each with
    ``--native_loader`` and without (:func:`_native_pair`), their steady steps
    held to ``steady[tag]``, the launches of a later step of ``phase_train`` and
    ``phase_train_hifi``. At the defaults the Encodec run inits its 12 layers
    in its first two steps and its last two are steady."""
    import tempfile

    from academicodec_tpu_torch.cli import train_encodec, train_hificodec
    from academicodec_tpu_torch.data.dataset import WavCropDataset, batch_iterator
    from academicodec_tpu_torch.data.native_loader import native_batch_iterator
    from academicodec_tpu_torch.data.wavio import write_wav
    from academicodec_tpu_torch.native.build import WAVLOADER_SRC, get_wavloader_lib, library_path
    from academicodec_tpu_torch.train.encodec import EncodecTrainer
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainer

    on_card = torch.device(device).type == "cuda"
    t0 = t_phase = time.perf_counter()
    get_wavloader_lib()
    result = {"library": library_path(WAVLOADER_SRC).name, "load_or_build_s": time.perf_counter() - t0}
    sr = width["sr"]
    cfg, raw = hifi_recipe(**(hifi_model or {}))
    if cfg.sampling_rate != sr:
        raise ValueError(f"the HiFi-Codec recipe runs at {cfg.sampling_rate} Hz, the Encodec width at {sr}")
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "wavs")
        os.makedirs(data)
        for i in range(n_files):
            write_wav(os.path.join(data, f"n{i:02d}.wav"),
                      (rng.standard_normal(int(file_seconds * sr)) * 0.1).astype(np.float32), sr)
        segment = int(segment_seconds * sr)
        equal = {}
        for mixture in (0.0, 0.3):
            ds = WavCropDataset(data, segment, sample_rate=sr, mixture_prob=mixture, seed=3)
            py = list(batch_iterator(ds, batch, seed=3, epochs=1, num_workers=workers))
            nat = list(native_batch_iterator(ds.files, segment, batch, sample_rate=sr, mixture_prob=mixture,
                                             seed=3, epochs=1, num_workers=workers))
            equal[mixture] = len(py) == len(nat) > 0 and all(np.array_equal(a, b) for a, b in zip(py, nat))
        result["epoch_bit_identical"] = equal
        rates = {}
        for tag, (seg, bs) in (("train_encodec", (segment, 16)), ("train_hificodec", (hifi_segment, 10))):
            ds = WavCropDataset(data, seg, sample_rate=sr, seed=4)
            row = {"native_batches_per_s": [], "python_batches_per_s": []}
            for feed in ("native", "python", "python", "native"):
                it = (native_batch_iterator(ds.files, seg, bs, sample_rate=sr, seed=4, num_workers=workers)
                      if feed == "native" else batch_iterator(ds, bs, seed=4, num_workers=workers))
                next(it)  # the set-up and the first batch, outside the window
                t0 = time.perf_counter()
                for _ in range(rate_batches):
                    next(it)
                row[f"{feed}_batches_per_s"].append(rate_batches / (time.perf_counter() - t0))
                it.close()
            row.update(segment=seg, batch=bs, batches=rate_batches, workers=workers)
            rates[tag] = row
        result["batches_per_s"] = rates
        print(f"[native_loader] {result['library']} ready in {result['load_or_build_s']:.2f} s; one epoch "
              f"bit-identical to batch_iterator (mixture 0, 0.3): {equal}; batches a second over {rate_batches} "
              f"after the first, {workers} threads, fed native, Python, Python, native: "
              + "; ".join(f"{t} ({r['batch']} x {r['segment']}) native "
                          + " ".join(f"{v:.1f}" for v in r["native_batches_per_s"]) + ", Python "
                          + " ".join(f"{v:.1f}" for v in r["python_batches_per_s"]) for t, r in rates.items())
              + f" ({n_files} files of {file_seconds} s; host clock)")
        if not all(equal.values()):
            raise AssertionError(f"native loader: an epoch differs from batch_iterator: {equal}")

        enc_flags = ["--sr", str(sr), "--ratios", *map(str, width["ratios"]),
                     "--target_bandwidths", *map(str, width["target_bandwidths"]),
                     "--n_filters", str(width["n_filters"]), "--dimension", str(width["dimension"]),
                     "--bins", str(width["bins"]), "--device", str(device), "--train_data_path", data,
                     "--valid_data_path", data, "--batch_size", str(batch), "--segment_seconds", str(segment_seconds),
                     "--n_epochs", "0", "--discriminator_iter_start", "1", "--debug_tiny_discs"]

        def run_encodec(native):
            train_encodec.main(enc_flags + ["--path", os.path.join(tmp, f"enc_{native}")]
                               + (["--native_loader"] if native else []))

        if not on_card:  # the plain versions launch nothing
            steady = {tag: {k: 0 for k in launches} for tag, launches in steady.items()}
        result["train_encodec"] = _native_pair("train_encodec", EncodecTrainer, run_encodec, steady["train_encodec"])

        config = os.path.join(tmp, "hifi.json")
        with open(config, "w") as fh:
            json.dump({**raw, **(hifi_model or {}), "segment_size": hifi_segment}, fh)

        def run_hifi(native):
            train_hificodec.main(["--config", config, "--input_training_file", data, "--input_validation_file",
                                  data, "--checkpoint_path", os.path.join(tmp, f"hifi_{native}"), "--batch_size",
                                  str(hifi_batch), "--training_epochs", "1", "--stdout_interval", "1",
                                  "--device", str(device)] + (["--native_loader"] if native else []))

        result["train_hificodec"] = _native_pair("train_hificodec", HiFiCodecTrainer, run_hifi,
                                                 steady["train_hificodec"])
    result["wall_s"] = time.perf_counter() - t_phase
    print(f"[native_loader] the phase {result['wall_s']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# data parallelism (phase_parallel)

# JAX's contract of a data-parallel step (tests/test_train.py:253-296): an N-rank
# step equals the 1-rank step on the same global batch, the rank-major
# concatenation of the ranks' batches: the losses rtol, the codebooks
# (Encodec's embed) and the parameters within atol + rtol |value|, codes equal.
# Adam amplifies the f32 noise of a reordered gradient sum where the noise is
# not small against the gradient itself: its sign, or its size against Adam's
# eps, and so Adam's step of up to lr, is then not resolved (JAX's test holds
# only the first leaf, :293-296, and notes this at :188-193). Such an element
# (in some step the runs' gradients differ by unresolved_rel of the 1-rank
# run's own or more) is held to Adam's bound, 2 lr a step, instead; every
# gradient is held within grad_rel of the larger of its leaf's max and a
# hundredth of its phase's (TRAIN_CROSS_LIMITS' gradient limit). The codebook
# entries that a code parted at a near-tie moved (dp_compare) are left out of
# the codebook limit, up to moved_share of the entries: one frame parting at
# layer 0 of 12 moves at most 24 of a 768-entry codebook, 3%
DP_LIMITS = dict(loss_rtol=1e-4, embed_atol=1e-5, embed_rtol=1e-4, param_atol=1e-5, param_rtol=1e-4, grad_rel=5e-3,
                 unresolved_rel=1e-2, moved_share=0.05)
# the losses held (loss_rtol): the generator's and discriminators' totals, and
# the Encodec feature loss, whose mean|r| normaliser spans the ranks
DP_LOSSES = {"encodec": ("loss_g", "feat_loss", "loss_d"), "hifi": ("loss_gen_all", "loss_disc_all")}
DP_F32_TIE = 2.0**-20  # 16 ulps of f32


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels where torch has them (``index_add_``'s sums without
    atomics, cuDNN's deterministic convs); ops without one warn and run as
    they are. Restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*does not have a deterministic implementation.*")
            yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]


@contextlib.contextmanager
def world_of_one(device, backend=None):
    """A process group of this process alone, joined through
    ``parallel.init_from_env`` from the environment torchrun would give it
    (world 1, a TCP store on localhost) -> ``(group, device)``; destroyed after."""
    import torch.distributed as dist

    from academicodec_tpu_torch.parallel import init_from_env

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        group, dev = init_from_env(device, backend)
        try:
            yield group, dev
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_trainer(family: str, cfg, device, group=None):
    """The Encodec (``family`` "encodec") or HiFi-Codec ("hifi") trainer of ``cfg``."""
    if family == "encodec":
        from academicodec_tpu_torch.train.encodec import EncodecTrainer

        return EncodecTrainer(cfg, device=device, group=group)
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainer

    return HiFiCodecTrainer(cfg, device=device, group=group)


# what a comparison holds (dp_compare). Everything (DP_HELD_ALL) on the CPU,
# where the 1-rank run's latents are the ranks' bit for bit (dp_run's
# ``blocks``) and no code parts, and at world 1. On the card a search after
# an EMA update may part at the f32 near-ties of codebooks whose sums were
# reordered, and a parted code moves its entries' EMA by 1 - decay, so that a
# later search parts at wider margins: there an update run at the trainer's
# learning rate holds the losses and the parameters, and the first step's
# gradients and the first search's codes (later ones follow a generator that
# Adam's noise has moved) (DP_HELD_UPDATE); a run at learning rate 0 keeps
# the parameters where they are and holds everything, its searches' codes
# with the card's near-tie allowance
DP_HELD_UPDATE = ("loss", "grads0", "params", "codes0")
DP_HELD_ALL = ("loss", "grads", "params", "codes", "embed")


def dp_case(family: str, cfg, x: torch.Tensor, steps: int, seed: int = 0, fault=None, ref=None,
            held=DP_HELD_ALL, inited: bool = False) -> dict:
    """One data-parallel comparison: the trainer config, the global batch ``x``
    (on the device the start state is made on), the step count and the start
    state as a CPU state dict: the seeded state (HiFi-Codec's GRVQ codebooks
    spread over ``x``'s latents), with ``inited`` after one plain step that
    k-means-inits every Encodec layer on ``x``, its codebooks then spread over
    ``x``'s latents (:func:`spread_training_codebooks`: k-means codebooks on
    a random encoder's latents leave distances ill conditioned, and a search
    after a reordered EMA sum parts there) and the last entry of each layer
    dead (cluster size 1), so that the step's first update replaces it from a
    drawn row of the global batch. ``fault``: a :func:`dp_fault` control;
    ``ref``: the case whose 1-rank run this one is held against; ``held``:
    what :func:`dp_compare` holds."""
    from academicodec_tpu_torch.train.encodec import ForwardDraws, StepDraws

    trainer = dp_trainer(family, cfg, x.device)
    state = trainer.init_state(seed)
    if family == "hifi":
        spread_codebooks(state.generator, latent_frames(state.generator, x), seed=seed)
    if inited:
        vq = state.generator.quantizer.vq
        drawn = trainer.draw(state, tuple(x.shape))
        trainer.train_step(state, x, draws=StepDraws(ForwardDraws(vq.num_quantizers, drawn.g.rows),
                                                     ForwardDraws(vq.num_quantizers, drawn.d.rows)))
        spread_training_codebooks(state.generator, x, seed=seed)
        with torch.no_grad():
            vq.cluster_size[:, -1] = THRESHOLD_EMA_DEAD_CODE / 2
            vq.embed_avg[:, -1] = vq.embed[:, -1] * vq.cluster_size[:, -1:]
    return dict(family=family, cfg=cfg, x=x.cpu(), steps=steps, seed=seed, start=copy.deepcopy(state.state_dict()),
                fault=fault, ref=ref, held=held)


def dp_state_tensors(state) -> dict:
    """Every tensor of a training state by name, on the CPU: both modules'
    parameters and buffers (the codebooks' EMA state, the spectral norm's ``u``)
    and both optimizers' moments."""
    out = {}
    for tag, module, opt in (("g", state.generator, state.g_opt), ("d", state.discriminators, state.d_opt)):
        names = {p: n for n, p in module.named_parameters()}
        out.update({f"{tag}.param.{n}": t.detach().cpu().clone() for n, t in module.named_parameters()})
        out.update({f"{tag}.buffer.{n}": t.detach().cpu().clone() for n, t in module.named_buffers()})
        for p, st in opt.state.items():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{tag}.{k}.{names[p]}"] = st[k].detach().cpu().clone()
    return out


def dp_run(trainer, case: dict, record: bool = False, blocks: int = 1) -> dict:
    """``case``'s steps from its start state on its global batch, this rank's
    block of it when the trainer has a group. An Encodec run's first step from
    un-inited codebooks draws every layer in both phases, so that every layer's
    k-means runs in it. ``blocks`` (a run without a group): the encoder, which
    maps each item alone, runs on ``blocks`` equal row blocks of each
    microbatch, the rows each of that many ranks holds, so that the latents
    are the ranks' bit for bit (a library LSTM's and a conv's sums depend on
    the batch size) ->
    the end state's tensors, and each step's metrics, launches, ms (CUDA events
    on the card), (Encodec) each phase's codes of each microbatch, and with
    ``record`` the gradients each update took and (Encodec) each search's
    latents, codebooks, whether every layer was inited, cluster sizes and
    drawn rows as it began (:func:`_near_ties`, :func:`_moved_entries`)."""
    from academicodec_tpu_torch.parallel import rank, shard_batch, world_size
    from academicodec_tpu_torch.train.encodec import EncodecTrainer, ForwardDraws, StepDraws

    group, encodec = trainer.group, isinstance(trainer, EncodecTrainer)
    state = trainer.init_state(case["seed"])
    state.load_state_dict(copy.deepcopy(case["start"]))  # the optimizers would step the start's moments
    x = case["x"]
    local = shard_batch(x, rank(group), world_size(group)).to(trainer.device)
    on_card = trainer.device.type == "cuda"
    out = dict(metrics=[], codes=[], launches=[], ms=[], grads=[], searches=[])
    if encodec and blocks > 1:
        encoder = state.generator.encoder
        whole = encoder.forward
        encoder.forward = lambda wav: torch.cat([whole(part) for part in wav.chunk(blocks)])
    seen = []
    if record and encodec:
        def searched(mod, args, kwargs):
            rows = kwargs.get("draws")
            seen.append((args[0].detach().float().cpu().clone(), mod.embed.detach().cpu().clone(),
                         all(mod.inited_layers()), mod.cluster_size.detach().cpu().clone(),
                         None if rows is None else rows.detach().cpu().clone(), list(mod.inited_layers())))

        state.generator.quantizer.vq.register_forward_pre_hook(searched, with_kwargs=True)
    for i in range(case["steps"]):
        kw = {}
        if encodec:
            kw["return_codes"] = True
            if i == 0 and not all(state.generator.quantizer.vq.inited_layers()):
                n_q = state.generator.quantizer.vq.num_quantizers
                drawn = trainer.draw(state, tuple(x.shape))
                kw["draws"] = StepDraws(ForwardDraws(n_q, drawn.g.rows), ForwardDraws(n_q, drawn.d.rows))
        res = []
        reset_launches()
        out["ms"].append(_train_seconds(lambda: res.append(trainer.train_step(state, local, **kw)), on_card) * 1e3)
        out["launches"].append(read_launches())
        state, metrics = res[0][:2]
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if encodec:
            out["codes"].append({ph: [c.cpu() for c in cs] for ph, cs in res[0][2].items()})
        out["searches"].append(seen[:])
        seen.clear()
        if record:
            out["grads"].append({
                f"{tag}.{n}": p.grad.detach().cpu().clone()
                for tag, module in (("g", state.generator), ("d", state.discriminators))
                for n, p in module.named_parameters() if p.grad is not None})
    out["state"] = dp_state_tensors(state)
    return out


@contextlib.contextmanager
def dp_fault(name=None):
    """Controls that a data-parallel comparison must catch: ``no_ema`` drops the
    codebooks' sums over the ranks (each rank's own EMA, as a plain DDP wrap
    keeps it), ``local_norm`` the feature loss's (``mean|r|`` of this rank's
    rows), ``local_split`` takes each microbatch from this rank's rows in their
    own order instead of JAX's global one."""
    from academicodec_tpu_torch.losses import gan
    from academicodec_tpu_torch.quant import core_vq
    from academicodec_tpu_torch.train import encodec

    def no_sum(tensors, group=None):
        return None

    patches = {None: [], "no_ema": [(core_vq, "all_reduce_sum_", no_sum)],
               "local_norm": [(gan, "all_reduce_sum_", no_sum), (gan, "world_size", lambda group=None: 1)],
               "local_split": [(encodec, "microbatches", lambda x, k, group=None: x.reshape(k, -1, *x.shape[1:]))]}
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches[name]]
    for m, a, f in patches[name]:
        setattr(m, a, f)
    try:
        yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)


def dp_child(spec_path: str) -> None:
    """One rank of :func:`dp_launch`: join the gloo group from the torchrun
    environment, run every case of the spec and save the results."""
    import torch.distributed as dist

    from academicodec_tpu_torch.parallel import init_from_env, rank

    import faulthandler

    spec = torch.load(spec_path, weights_only=False)
    faulthandler.dump_traceback_later(spec["timeout"], exit=True)  # a stuck rank shows where in its log
    group, device = init_from_env(spec["device"], backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if device.type == "cpu":
        torch.set_num_threads(1)
    results = {}
    with deterministic():
        for name, case in spec["cases"].items():
            with dp_fault(case["fault"]):
                results[name] = dp_run(dp_trainer(case["family"], case["cfg"], device, group), case, record=True)
    torch.save(results, spec["out"].format(rank=rank(group)))
    dist.destroy_process_group()


def dp_launch(cases: dict, device, world: int, workdir: str, timeout: float = 900.0, meanwhile=None) -> list:
    """Run ``cases`` in ``world`` processes joined with gloo, each started with
    the environment torchrun gives a rank (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) -> each rank's results;
    on a card every rank runs on ``device`` (``cuda`` is ``cuda:0``), and
    ``meanwhile()`` runs here while they do. A process that fails stops the
    others and fails the call; every process is stopped before it returns."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "spec.pt")
    torch.save(dict(cases=cases, device=str(device), out=os.path.join(workdir, "rank{rank}.pt"),
                    timeout=max(1.0, timeout - 30)), spec_path)
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.dp_child({spec_path!r})"],
                                          cwd=root, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        if meanwhile is not None:
            meanwhile()
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait for it
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(os.path.join(workdir, f"rank{r}.log")) as fh:
                tails.append(f"rank {r} of {world} exited {procs[r].returncode}:\n{fh.read()[-3000:]}")
        raise AssertionError("\n".join(tails))
    out = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    for r in range(world):
        os.remove(os.path.join(workdir, f"rank{r}.pt"))
    os.remove(spec_path)
    return out


def dp_lr(cfg) -> float:
    return cfg.lr if hasattr(cfg, "lr") else cfg.learning_rate


def state_distance(a: dict, b: dict) -> float:
    """The largest |difference| over two runs' end-state tensors."""
    return max(float((a["state"][k].double() - b["state"][k].double()).abs().max()) if a["state"][k].numel() else 0.0
               for k in a["state"])


def _moved_entries(one: dict, ranks: list) -> set:
    """The codebook entries ``(layer, entry)`` that a parted code moved, from
    the searches of ``one`` (a recorded 1-rank run) against the ranks'. A frame
    whose codes part first at layer ``l`` has other residuals from ``l + 1``
    on: the entries it chose at ``l`` and later, in either run, take other EMA
    sums; an entry that a search replaced as a dead code (cluster size below
    the threshold as it began) takes the drawn row's residual, which moved
    where that row parted before the entry's layer; a layer that a search
    k-means-inits is moved whole when any frame parted before it."""
    moved = set()
    for s, codes in enumerate(one["codes"]):
        for ph, mbs in codes.items():
            for i, want in enumerate(mbs):
                n_q = want.shape[0]
                want = want.reshape(n_q, -1).long()
                got = torch.cat([r["codes"][s][ph][i] for r in ranks], dim=1).reshape(n_q, -1).long()
                differ = want != got
                if not differ.any():
                    continue
                layer = torch.arange(n_q)[:, None]
                first = torch.where(differ.any(0), differ.int().argmax(0), n_q)  # each frame's first parted layer
                after = (layer >= first).expand_as(want)
                for c in (want, got):
                    moved |= set(zip(layer.expand_as(c)[after].tolist(), c[after].tolist()))
                search = one["searches"][s][i + (len(mbs) if ph == "d" else 0)] if one["searches"][s] else None
                if search is None:  # not recorded: the codes' own check fails
                    continue
                cluster, rows, inited = search[3][:n_q], search[4][:n_q].long(), search[5][:n_q]
                dead = (cluster < THRESHOLD_EMA_DEAD_CODE) & (first[rows] < layer)
                moved |= {(l, k) for l, k in dead.nonzero().tolist()}
                for l in range(n_q):
                    if not inited[l] and bool((first < l).any()):
                        moved |= {(l, k) for k in range(cluster.shape[1])}
    return moved


def dp_compare(one: dict, ranks: list, family: str, lr: float, held=DP_HELD_ALL, limits=DP_LIMITS,
               ties: bool = False) -> dict:
    """``ranks`` (each rank's run, one global batch) against ``one`` (the 1-rank
    run, made at learning rate ``lr``) under :data:`DP_LIMITS`, in what ``held``
    names, and the ranks against each other bitwise -> ``{"failures": [...],
    "loss_rel", "max_embed_diff", "max_param_diff", "unresolved", "near_ties",
    "moved_entries", "moved_share"}`` (``unresolved``: the parameter elements
    held to Adam's bound). Codes must be equal; with ``ties`` (the card) a
    held search may part at a near-tie of the 1-rank search. The codebook
    entries a parted code moved (:func:`_moved_entries`) are left out of the
    codebook limit and of ``max_embed_diff``, and may be at most
    ``moved_share`` of the entries."""
    failures = []
    r0 = ranks[0]
    for j, r in enumerate(ranks[1:], 1):
        unequal = [k for k, v in r0["state"].items() if not torch.equal(v, r["state"][k])]
        if unequal:
            failures.append(f"rank {j}'s state differs from rank 0's in {len(unequal)} tensors, e.g. {unequal[:3]}")
        if r["metrics"] != r0["metrics"]:
            failures.append(f"rank {j}'s metrics differ from rank 0's")
    loss_rel = 0.0
    for loss in DP_LOSSES[family]:
        rel = max(abs(a[loss] - b[loss]) / abs(b[loss]) if b[loss] else (0.0 if a[loss] == b[loss] else math.inf)
                  for a, b in zip(r0["metrics"], one["metrics"]))
        loss_rel = max(loss_rel, rel)
        if "loss" in held and not rel <= limits["loss_rtol"]:
            failures.append(f"{loss} {[m[loss] for m in r0['metrics']]} vs {[m[loss] for m in one['metrics']]}")
    diffs = {"embed": 0.0, "param": 0.0}
    steps = len(one["metrics"])
    # the gradients of each step (recorded), else the end state's first moments
    if one.get("grads") and r0.get("grads"):
        grads = list(zip(one["grads"], r0["grads"]))
    else:
        grads = [tuple({k.replace(".exp_avg.", ".", 1): v for k, v in run["state"].items() if ".exp_avg." in k}
                       for run in (one, r0))]
    for t, (want, got) in enumerate(grads):
        if "grads" in held or "grads0" in held and t == 0:
            rel = _grad_compare(got, want)["grad_rel"]
            failures += [f"step {t} gradient of {n}: max |diff| {v:.3g} of its scale" for n, v in rel.items()
                         if v > limits["grad_rel"]]
    moved = _moved_entries(one, ranks) if family == "encodec" else set()
    entries = one["state"].get("g.buffer.quantizer.vq.embed", torch.zeros(1, 1)).shape[:2].numel()
    moved_share, unresolved = len(moved) / entries, 0
    for k, want in one["state"].items():
        kind = "param" if ".param." in k else "embed" if k.endswith("quantizer.vq.embed") else None
        if kind is None or (kind + "s" if kind == "param" else kind) not in held:
            continue
        got = r0["state"][k]
        d = (got - want).abs()
        outside = d > limits[f"{kind}_atol"] + limits[f"{kind}_rtol"] * want.abs()
        if kind == "param":
            tag, name = k.split(".param.")
            loose = torch.zeros_like(outside)
            for g_want, g_got in grads:
                if f"{tag}.{name}" in g_want:  # Adam's step is not resolved where the gradients part by this
                    loose |= (g_got[f"{tag}.{name}"] - g_want[f"{tag}.{name}"]).abs() >= (
                        limits["unresolved_rel"] * g_want[f"{tag}.{name}"].abs())
            unresolved += int((outside & loose).sum())
            outside = outside & ~(loose & (d <= 2 * lr * steps))
        else:
            if moved:
                layer, entry = torch.tensor(sorted(moved)).T
                outside[layer, entry], d[layer, entry] = False, 0.0
            if moved_share > limits["moved_share"]:
                failures.append(f"{len(moved)} codebook entries moved by parted codes, {moved_share:.3g} of them "
                                f"(limit {limits['moved_share']})")
        diffs[kind] = max(diffs[kind], float(d.max()))
        if outside.any():
            failures.append(f"{k}: max |diff| {float(d.max()):.3g} ({int(outside.sum())} of {d.numel()} outside "
                            "the limit)")
    # codes: equal, but with ``ties`` where a search after the init step parts
    # at a near-tie of the 1-rank run's own search (the codebooks then differ
    # by the EMA sums' reordering, as the card's from the CPU's in
    # phase_train's check): a margin below NEAR_TIE_MARGIN, or below the f32
    # resolution of the expanded distance |r|^2 - 2 r.e + |e|^2, DP_F32_TIE x
    # its conditioning
    near = []
    for s, codes in enumerate(one["codes"]):
        for ph, mbs in codes.items():
            for i, want in enumerate(mbs):
                if "codes" not in held and not ("codes0" in held and (s, ph, i) == (0, "g", 0)):
                    continue
                got = torch.cat([r["codes"][s][ph][i] for r in ranks], dim=1)
                if torch.equal(got, want):
                    continue
                search = one["searches"][s][i + (len(mbs) if ph == "d" else 0)] if one["searches"] else None
                # a k-means init search is held exactly: its codebooks are made in the search
                split = _near_ties(search[:2], got, want) if ties and search is not None and search[2] else []
                if split and all(margin < max(NEAR_TIE_MARGIN, DP_F32_TIE * cond) for *_, margin, cond in split):
                    near += split
                else:
                    failures.append(f"step {s} phase {ph} microbatch {i}: {int((got != want).sum())} codes differ "
                                    f"(margin, conditioning {[(round(m, 6), round(cd, 1)) for *_, m, cd in split][:4]})")
    return dict(failures=failures, loss_rel=loss_rel, max_embed_diff=diffs["embed"], max_param_diff=diffs["param"],
                unresolved=unresolved, near_ties=len(near), moved_entries=len(moved), moved_share=moved_share)


def _parallel_world1(device, backend=None, cases=None) -> dict:
    """Phase (a): each case's steps through the data-parallel code in a process
    group of this process alone (NCCL on the card) and through the plain code,
    from one state with the same draws, in turns (plain, parallel, parallel,
    plain), with deterministic kernels where torch has them. Each must meet
    :data:`DP_LIMITS` against the plain run, be no farther from it than the
    plain run's repeat, and launch K1-K4 as often a step."""
    out = {}
    with deterministic(), world_of_one(device, backend) as (group, dev):
        for name, case in cases.items():
            runs = [dp_run(dp_trainer(case["family"], case["cfg"], dev, g), case)
                    for g in (None, group, group, None)]
            plain, par = runs[0], runs[1]
            cmp = dp_compare(plain, [par], case["family"], dp_lr(case["cfg"]))
            d_par, d_repeat = state_distance(par, plain), state_distance(runs[3], plain)
            steady = slice(1, None) if case["steps"] > 1 else slice(None)
            r = dict(steps=case["steps"], batch=int(case["x"].shape[0]), samples=int(case["x"].shape[1]),
                     distance_parallel_vs_plain=d_par, distance_plain_repeat=d_repeat,
                     distance_parallel_repeat=state_distance(runs[2], par),
                     launches_parallel=par["launches"], launches_plain=plain["launches"],
                     step_ms_parallel=statistics.median(runs[1]["ms"][steady] + runs[2]["ms"][steady]),
                     step_ms_plain=statistics.median(runs[0]["ms"][steady] + runs[3]["ms"][steady]),
                     first_step_ms_parallel=par["ms"][0], first_step_ms_plain=plain["ms"][0],
                     loss_rel=cmp["loss_rel"], max_param_diff=cmp["max_param_diff"],
                     max_embed_diff=cmp["max_embed_diff"], failures=cmp["failures"])
            if d_par > d_repeat:
                r["failures"].append(f"parallel vs plain {d_par:.3g} > plain vs plain {d_repeat:.3g}")
            if any(a != b for run in runs[1:] for a, b in zip(run["launches"], plain["launches"])):
                r["failures"].append(f"launches differ: parallel {par['launches']}, plain {plain['launches']}")
            print(f"[parallel] (a) {name}, world 1 ({torch.distributed.get_backend(group)}): {r['steps']} "
                  f"steps of {r['batch']} x {r['samples']}; step median {r['step_ms_parallel']:.2f} ms parallel vs "
                  f"{r['step_ms_plain']:.2f} ms plain (first step {r['first_step_ms_parallel']:.1f} / "
                  f"{r['first_step_ms_plain']:.1f}); distances parallel-plain {d_par:.3g}, plain-plain {d_repeat:.3g}; "
                  f"loss rel {r['loss_rel']:.3g}, params {r['max_param_diff']:.3g}, embed {r['max_embed_diff']:.3g}; "
                  f"launches a step {par['launches'][-1]}; failures {r['failures']}")
            out[name] = r
    return out


def _parallel_ranks(device, cases: dict, world: int = 2, workdir=None, timeout: float = 600.0) -> dict:
    """Phase (b): ``cases`` in ``world`` gloo processes (on one card, when
    ``device`` is one), each held against its 1-rank run in this process
    (:func:`dp_compare`) -> each case's comparison."""
    import tempfile

    refs, out = {}, {}

    def one_rank_runs():
        with deterministic():
            for base in sorted({case["ref"] or name for name, case in cases.items()}):
                refs[base] = dp_run(dp_trainer(cases[base]["family"], cases[base]["cfg"], device), cases[base],
                                    record=True, blocks=world)

    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
        print(f"[parallel] (b) {len(cases)} cases in {world} gloo processes on {device} (their logs: {workdir})",
              flush=True)
        ranks = dp_launch(cases, device, world, workdir, timeout=timeout, meanwhile=one_rank_runs)
    for name, case in cases.items():
        cmp = dp_compare(refs[case["ref"] or name], [r[name] for r in ranks], case["family"], dp_lr(case["cfg"]),
                         case["held"], ties=torch.device(device).type == "cuda")
        cmp["launches_rank0"] = ranks[0][name]["launches"]
        print(f"[parallel] (b) {name}: {world} gloo ranks against 1 rank, {case['steps']} steps of "
              f"{tuple(case['x'].shape)} (accum {case['cfg'].accum_steps}, fault {case['fault']}): loss rel "
              f"{cmp['loss_rel']:.3g}, params {cmp['max_param_diff']:.3g} ({cmp['unresolved']} elements held to "
              f"Adam's bound), embed {cmp['max_embed_diff']:.3g} over the entries no parted code moved (moved: "
              f"{cmp['moved_entries']}, {cmp['moved_share']:.3g} of them, limit {DP_LIMITS['moved_share']}), "
              f"near-ties {cmp['near_ties']}; failures {cmp['failures'][:4]}")
        out[name] = cmp
    return out


def _parallel_serving(device, dtype=torch.bfloat16, n_files=8, seconds=10.0, extract_files=4,
                      extract_seconds=(1.0, 3.0), preset=FLAGSHIP, hifi_preset=HIFI, hifi_overrides=None,
                      **overrides) -> dict:
    """Phase (c): ``compress_batch`` over ``devices=[device]`` against the plain
    compressor (blobs byte-identical, the same launches), and ``cli.extract_tokens
    --data_parallel`` against the plain batched run (tokens identical)."""
    import dataclasses
    import tempfile

    from academicodec_tpu_torch.cli import extract_tokens
    from academicodec_tpu_torch.data.wavio import write_wav

    on_card = torch.device(device).type == "cuda"
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    batch = seeded_wav(n_files, int(round(seconds * model.sample_rate)), "cpu", seed=4)
    wavs = [row.numpy() for row in batch]
    spread_codebooks(model, latent_frames(model, batch[:2]))
    out = {}
    for tag, comp in (("plain", SoundStreamCompressor(model)), ("parallel", SoundStreamCompressor(model, devices=[device]))):
        comp.compress_batch(wavs)  # warm-up
        if on_card:
            torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        blobs = comp.compress_batch(wavs)
        out[f"compress_{tag}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"compress_{tag}_launches"] = read_launches()
        out[f"compress_{tag}_blobs"] = blobs
    same = out.pop("compress_plain_blobs") == out.pop("compress_parallel_blobs")
    out["compress_blobs_identical"] = same
    del model
    model, ewavs, _lengths = extract_corpus(device, extract_files, *extract_seconds, hifi_preset, **(hifi_overrides or {}))
    sr = model.config.sampling_rate
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "wavs"))
        for i, w in enumerate(ewavs):
            write_wav(os.path.join(tmp, "wavs", f"f{i}.wav"), w, sr)
        ckpt, config = os.path.join(tmp, "g_00000000"), os.path.join(tmp, "config.json")
        torch.save({part: getattr(model, part).state_dict() for part in ("encoder", "generator", "quantizer")}, ckpt)
        with open(config, "w") as fh:
            json.dump(dataclasses.asdict(model.config), fh)
        del model
        flags = ["--config", config, "--model_path", ckpt, "--input", os.path.join(tmp, "wavs"), "--batch_files",
                 str(extract_files), "--bucket_seconds", str(extract_seconds[1]), "--device", str(device)]
        tokens = {}
        for tag, extra in (("plain", []), ("parallel", ["--data_parallel"])):
            reset_launches()
            t0 = time.perf_counter()
            tokens[tag] = extract_tokens.main(flags + ["--outputdir", os.path.join(tmp, tag), *extra])
            out[f"extract_{tag}_s"] = time.perf_counter() - t0
            out[f"extract_{tag}_launches"] = read_launches()
    out["extract_tokens_identical"] = tokens["plain"].keys() == tokens["parallel"].keys() and all(
        np.array_equal(tokens["plain"][k], tokens["parallel"][k]) for k in tokens["plain"])
    print(f"[parallel] (c) compress_batch {n_files} x {seconds} s {preset} {dtype}: devices=[{device}] "
          f"{out['compress_parallel_ms']:.2f} ms vs plain {out['compress_plain_ms']:.2f} ms (host clock), blobs "
          f"identical {same}, launches {out['compress_parallel_launches']} / {out['compress_plain_launches']}; "
          f"extract_tokens --data_parallel {extract_files} files: tokens identical {out['extract_tokens_identical']}, "
          f"launches {out['extract_parallel_launches']} / {out['extract_plain_launches']}, "
          f"{out['extract_parallel_s']:.2f} s vs {out['extract_plain_s']:.2f} s")
    if not (same and out["extract_tokens_identical"]
            and out["compress_parallel_launches"] == out["compress_plain_launches"]
            and out["extract_parallel_launches"] == out["extract_plain_launches"]):
        raise AssertionError(f"parallel (c): {out}")
    return out


def parallel_cases_world1(device, encodec=TRAIN_RECIPE, enc_batch=16, enc_seconds=1.0, enc_steps=4, hifi_model=None,
                          hifi_discs=HIFI_TRAIN_DISCS, hifi_batch=10, hifi_samples=16000, hifi_steps=3) -> dict:
    """Phase (a)'s cases: the Encodec trainer at ``encodec``'s width (an init step,
    then ``enc_steps - 1``), the HiFi-Codec trainer at ``hifi_model``'s (the
    recipe's by default, or overrides of it, or a ``HiFiCodecConfig``), f32."""
    from academicodec_tpu_torch.train.encodec import EncodecTrainConfig
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig

    enc_cfg = EncodecTrainConfig(**encodec)
    x = seeded_wav(enc_batch, int(round(enc_seconds * enc_cfg.sr)), device, seed=5)
    model = hifi_recipe(**(hifi_model or {}))[0] if isinstance(hifi_model, (dict, type(None))) else hifi_model
    hifi_cfg = HiFiCodecTrainConfig(model=model, **hifi_discs)
    y = seeded_wav(hifi_batch, hifi_samples, device, seed=6)
    return {"encodec": dp_case("encodec", enc_cfg, x, enc_steps), "hifi": dp_case("hifi", hifi_cfg, y, hifi_steps)}


def dp_batch(batch: int, samples: int, device, seed: int) -> torch.Tensor:
    """Seeded noise whose rows fall from 0.1 to 0.01 in level, as loud and quiet
    files share a corpus: each rank's rows then have their own ``mean|r|``, which a
    rank-local feature-loss normaliser would show."""
    gains = torch.logspace(0, -1, batch)[:, None]
    return (seeded_wav(batch, samples, "cpu", seed=seed) * gains).to(device)


def parallel_cases_ranks(device, encodec=TRAIN_CROSS, enc_batch=16, enc_seconds=0.5, enc_steps=2,
                         hifi_model=HIFI_CROSS_MODEL, hifi_discs=HIFI_CROSS_DISCS, hifi_batch=4, hifi_samples=6400,
                         hifi_steps=2, accum=(2,), faults=(), held=None) -> dict:
    """Phase (b)'s cases, the first two for each ``accum_steps`` of ``accum``,
    the others for the last:

    * ``encodec_init_k*``: the Encodec trainer's k-means init step
      (:data:`DP_HELD_UPDATE`);
    * ``encodec_k*``: two steps from the state after a plain init step, its
      codebooks spread and a dead entry a layer (:func:`dp_case`), at the
      trainer's learning rate (:data:`DP_HELD_UPDATE`);
    * ``encodec_k*_lr0``: one such step at learning rate 0 (:data:`DP_HELD_ALL`:
      every search's codes and the codebooks' EMA state too);
    * ``hifi_k*``: the HiFi-Codec trainer, two steps (:data:`DP_HELD_UPDATE`).

    ``held`` (the CPU: :data:`DP_HELD_ALL`) replaces what each holds. Then the
    Encodec trainer again under each fault of ``faults``, held as the case of
    the last ``accum`` that shows it (``local_norm`` the update's loss,
    ``no_ema`` and ``local_split`` the codebooks at learning rate 0).
    An Encodec microbatch keeps several frames a codebook entry, else k-means
    leaves entries that tie exactly. The rows fall in level
    (:func:`dp_batch`), so that each rank's ``mean|r|`` differs."""
    import dataclasses

    from academicodec_tpu_torch.train.encodec import EncodecTrainConfig
    from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig

    enc_cfg = EncodecTrainConfig(**encodec)
    x = dp_batch(enc_batch, int(round(enc_seconds * enc_cfg.sr)), device, seed=7)
    hifi_cfg = HiFiCodecTrainConfig(model=hifi_recipe(**hifi_model)[0] if isinstance(hifi_model, dict) else hifi_model,
                                    **hifi_discs)
    y = dp_batch(hifi_batch, hifi_samples, device, seed=8)
    cases = {}
    for k in accum:
        enc_k = dataclasses.replace(enc_cfg, accum_steps=k)
        cases[f"encodec_init_k{k}"] = dp_case("encodec", enc_k, x, 1, held=held or DP_HELD_UPDATE)
        cases[f"encodec_k{k}"] = dp_case("encodec", enc_k, x, enc_steps, held=held or DP_HELD_UPDATE, inited=True)
    cases[f"encodec_k{k}_lr0"] = dp_case("encodec", dataclasses.replace(enc_k, lr=0.0), x, 1, inited=True,
                                         held=held or DP_HELD_ALL)
    cases[f"hifi_k{k}"] = dp_case("hifi", dataclasses.replace(hifi_cfg, accum_steps=k), y, hifi_steps,
                                  held=held or DP_HELD_UPDATE)
    for fault in faults:
        base = f"encodec_k{accum[-1]}" + ("" if fault == "local_norm" else "_lr0")
        cases[f"encodec_{fault}"] = dict(cases[base], fault=fault, ref=base)
    return cases


def phase_parallel(device="cuda", world1=None, ranks=None, serving=None) -> dict:
    """Data parallelism of the port (``parallel/``, ``--multihost``,
    ``--data_parallel``) on one card: (a) both GAN trainers at full width
    through the data-parallel code in an NCCL group of world 1 against the
    plain code (:func:`_parallel_world1`); (b) two gloo processes on the card at
    the cross-check's width with ``accum_steps`` 2, against one rank
    (:func:`_parallel_ranks`); (c) data-parallel serving (:func:`_parallel_serving`).
    ``world1``, ``ranks``, ``serving``: overrides of each part's cases or
    arguments."""
    t0 = time.perf_counter()
    result = dict(world1=_parallel_world1(device, cases=parallel_cases_world1(device, **(world1 or {}))))
    result["ranks"] = _parallel_ranks(device, parallel_cases_ranks(device, **(ranks or {})))
    result["serving"] = _parallel_serving(device, **(serving or {}))
    result["wall_s"] = time.perf_counter() - t0
    print(f"[parallel] the phase {result['wall_s']:.1f} s ({nvidia_smi() if torch.device(device).type == 'cuda' else 'cpu'})")
    failed = {f"{part} {k}": v["failures"] for part in ("world1", "ranks") for k, v in result[part].items()
              if v["failures"]}
    if failed:
        raise AssertionError(f"parallel: {failed}")
    return result


# time-sharded serving against unsharded serving on the same card. Encodec in f32
# (TF32 off): no sum of the path crosses a shard, so its tokens must be identical;
# HiFi-Codec in f32 sums the wide stages' GroupNorm statistics over the shards in
# another order (in f64), which can part a token at a near-tie (as batched against
# single extraction parted 6 of 14516, ROADMAP Queue 3 item 3): at most 1e-4 of
# them; Encodec in bf16 at the 1e-3 that batched-vs-single extraction is held to.
# Wavs decoded from the same codes: f32 within 1e-4 (cuDNN picks a conv's
# algorithm by its shape, so a shard's convs may sum in another order), bf16
# within the 0.05 of max |wav| that phase_stream allows a chunked decode.
# HiFi-Codec's bf16 tokens are held to the count an unsharded control parts
# (_seq_hifi_bf16), not to bf16_mismatch: in bf16 cuDNN's convs of the wide
# encoder stages round apart at other widths, and at random weights with spread
# codebooks such ulps part several percent of the tokens, sharded or not
# (PERF.md, time-sharded serving). K4's sharded stage is held bit for bit (_seq_k4_stage).
SEQ_LIMITS = dict(encodec_f32_mismatch=0.0, hifi_f32_mismatch=1e-4, bf16_mismatch=1e-3, f32_wav_atol=1e-4,
                  bf16_wav_rel=STREAM_WAV_REL_ERR_LIMIT, k4_partials_rel=1e-5)


def _seq_devices(device, shards: int) -> list:
    """``shards`` entries naming one device (``cuda`` as ``cuda:0``): that many time shards on one card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return [device] * shards


def _seq_encodec(device, dtype, seconds: float, shards: int, iters: int, preset: str, overrides: dict) -> dict:
    """(a) One stream of ``seconds`` through ``TimeShardedSoundStream`` on one and on
    ``shards`` time shards of one device, against the unsharded model."""
    from academicodec_tpu_torch.parallel.sequence import TimeShardedSoundStream

    on_card = torch.device(device).type == "cuda"
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    wav = seeded_wav(1, int(seconds * model.sample_rate), device, seed=21).to(dtype)
    spread_codebooks(model, latent_frames(model, wav))
    with torch.no_grad():
        ref_codes = model.encode(wav)
        ref_wav = model.decode(ref_codes)
    out = {"unsharded": {"codes": list(ref_codes.shape)}}
    if on_card:
        out["unsharded"]["ms"] = time_ms(lambda: model.decode(model.encode(wav)), iters)
    for n in (1, shards):
        ts = TimeShardedSoundStream(model, _seq_devices(device, n))
        reset_launches()
        codes = ts.encode(wav)
        y = ts.decode(codes)
        if on_card:
            torch.cuda.synchronize()
        launches = read_launches()
        codes, y = codes.gather(), y.gather()
        differ = int((codes != ref_codes).sum())
        same_codes_wav = ts.decode(ref_codes).gather()
        if dtype == torch.float32:
            wav_err, wav_limit = (same_codes_wav - ref_wav).abs().max().item(), SEQ_LIMITS["f32_wav_atol"]
            share_limit = SEQ_LIMITS["encodec_f32_mismatch"]
        else:
            wav_err, wav_limit = _rel_err(same_codes_wav, ref_wav), SEQ_LIMITS["bf16_wav_rel"]
            share_limit = SEQ_LIMITS["bf16_mismatch"]
        expected = {"rvq_encode": n if on_card else 0, "lstm2": 2 if on_card else 0, "resblock_tower": 0,
                    "resblock_tower_gn": 0}
        row = dict(shards=n, codes=list(codes.shape), tokens_differ=differ, tokens=ref_codes.numel(),
                   tokens_differ_limit=share_limit, wav_err=wav_err, wav_limit=wav_limit, launches=launches,
                   finite=bool(torch.isfinite(y.float()).all()), wav_shape=list(y.shape))
        if on_card:
            row["ms"] = time_ms(lambda: ts.decode(ts.encode(wav)).gather(), iters)
        out[f"{n} shards"] = row
        print(f"[sequence] {preset} {dtype} {seconds:g} s on {n} time shard(s): tokens differ {differ} of "
              f"{ref_codes.numel()} (limit {share_limit} of them), wav of the same codes "
              f"{'max abs diff' if dtype == torch.float32 else 'max abs diff / max |wav|'} {wav_err:.3g} "
              f"(limit {wav_limit}), launches {launches} (expected {expected}), "
              f"{row.get('ms', float('nan')):.3f} ms against {out['unsharded'].get('ms', float('nan')):.3f} "
              "unsharded")
        if not (differ <= share_limit * ref_codes.numel() and wav_err <= wav_limit and launches == expected
                and row["finite"] and codes.shape == ref_codes.shape and y.shape == ref_wav.shape):
            raise AssertionError(f"sequence: {preset} {dtype} on {n} shards: {row}")
    check_distinct("sequence", ref_codes)
    del model
    return out


def _seq_extract(device, seconds: float, shards: int, bucket_seconds: float, preset: str, overrides: dict) -> dict:
    """(b) One file of ``seconds`` through ``cli.extract_tokens`` with
    ``--sequence_parallel`` over ``shards`` time shards of one device against the
    same CLI without it, at exact length and with ``--bucket_seconds``; and the
    sharded decode of the unsharded tokens against the model's."""
    import dataclasses
    import os
    import tempfile

    from academicodec_tpu_torch.cli import extract_tokens
    from academicodec_tpu_torch.data.wavio import read_wav, write_wav
    from academicodec_tpu_torch.parallel.sequence import TimeShardedVQVAE

    on_card = torch.device(device).type == "cuda"
    model = load_codec(preset, device=device, **overrides)
    sr = model.config.sampling_rate
    wav = seeded_wav(1, int(seconds * sr), "cpu", seed=22)[0].numpy()
    spread_codebooks(model, latent_frames(model, torch.from_numpy(wav[None])))
    devs = ",".join(str(d) for d in _seq_devices(device, shards))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "wavs"))
        write_wav(os.path.join(tmp, "wavs", "f0.wav"), wav, sr)
        ckpt = os.path.join(tmp, "g_00000000")
        torch.save(model.reference_state_dict(), ckpt)
        config = os.path.join(tmp, "config.json")
        with open(config, "w") as fh:
            json.dump(dataclasses.asdict(model.config), fh)
        flags = ["--config", config, "--model_path", ckpt, "--input", os.path.join(tmp, "wavs")]
        for mode, bucket in (("exact", []), ("bucketed", ["--bucket_seconds", str(bucket_seconds)])):
            runs = {}
            for tag, extra in (("unsharded", ["--device", str(device)]),
                               ("sharded", ["--sequence_parallel", "--device", devs])):
                d = os.path.join(tmp, f"{mode}_{tag}")
                reset_launches()
                t0 = time.perf_counter()
                tokens = extract_tokens.main(flags + bucket + extra + ["--outputdir", d])
                if on_card:
                    torch.cuda.synchronize()
                runs[tag] = dict(tokens=tokens["f0"], wav=read_wav(os.path.join(d, "f0.wav"))[0],
                                 launches=read_launches(), wall_s=time.perf_counter() - t0)
            ref, got = runs["unsharded"]["tokens"], runs["sharded"]["tokens"]
            differ = int((got != ref).sum()) if got.shape == ref.shape else ref.size
            wav_diff = float(np.abs(runs["sharded"]["wav"] - runs["unsharded"]["wav"]).max())
            expected = {"rvq_encode": 0, "lstm2": 0,
                        **{k: shards * n if on_card else 0 for k, n in fused_stage_counts(model.config).items()}}
            row = dict(tokens=ref.size, tokens_differ=differ, tokens_differ_limit=SEQ_LIMITS["hifi_f32_mismatch"],
                       wav_files_max_abs_diff=wav_diff, launches=runs["sharded"]["launches"],
                       launches_unsharded=runs["unsharded"]["launches"],
                       wall_s=runs["sharded"]["wall_s"], wall_s_unsharded=runs["unsharded"]["wall_s"])
            out[mode] = row
            print(f"[sequence] cli.extract_tokens {mode} {preset} f32 {seconds:g} s, --sequence_parallel --device "
                  f"{devs}: tokens differ {differ} of {ref.size} (limit {SEQ_LIMITS['hifi_f32_mismatch']} of them), "
                  f"wav files max abs diff {wav_diff:.3g}, launches a file {row['launches']} (expected {expected}; "
                  f"unsharded {row['launches_unsharded']}), wall {row['wall_s']:.2f} s against "
                  f"{row['wall_s_unsharded']:.2f} s unsharded (model load and file IO included)")
            if not (differ <= SEQ_LIMITS["hifi_f32_mismatch"] * ref.size and row["launches"] == expected
                    and got.shape == ref.shape):
                raise AssertionError(f"sequence: cli.extract_tokens {mode}: {row}")
        with torch.no_grad():
            codes = torch.from_numpy(runs["unsharded"]["tokens"])
            y = TimeShardedVQVAE(model, _seq_devices(device, shards)).decode(codes).gather()
            err = (y - model.decode(codes)).abs().max().item()
        out["decode_same_tokens_max_abs_diff"] = err
        print(f"[sequence] {preset} f32 sharded decode of the same tokens: max abs diff {err:.3g} "
              f"(limit {SEQ_LIMITS['f32_wav_atol']})")
        if not err <= SEQ_LIMITS["f32_wav_atol"]:
            raise AssertionError(f"sequence: sharded HiFi-Codec decode differs by {err:.3g}")
    check_distinct("sequence", torch.from_numpy(runs["unsharded"]["tokens"]))
    del model
    return out


def _seq_hifi_bf16(device, seconds: float, shards: int, iters: int, preset: str, overrides: dict,
                   bucket_seconds: float) -> dict:
    """(b) in bf16, through ``TimeShardedVQVAE`` (the CLI serves f32): one file of
    ``seconds`` on ``shards`` time shards of one device against the unsharded
    model: the wav of the same tokens; the tokens, held to part no more of them
    than an unsharded control does (the unsharded model on the file padded to
    whole buckets and encoded with its length, whose convs run at other
    widths too); where the encode parts, layer by layer
    (:func:`_seq_encoder_stage_diffs`); and the roundtrip's ms."""
    from academicodec_tpu_torch.parallel.sequence import TimeShardedVQVAE

    on_card = torch.device(device).type == "cuda"
    model = load_codec(preset, device=device, dtype=torch.bfloat16, **overrides)
    wav = seeded_wav(1, int(seconds * model.config.sampling_rate), device, seed=24).to(torch.bfloat16)
    spread_codebooks(model, latent_frames(model, wav))
    ts = TimeShardedVQVAE(model, _seq_devices(device, shards))
    with torch.no_grad():
        ref = model.encode(wav)
        ref_wav = model.decode(ref)
        T = wav.shape[-1]
        bucket = round(bucket_seconds * model.config.sampling_rate)
        control = model.encode(torch.nn.functional.pad(wav, (0, -(-T // bucket) * bucket - T)),
                               lengths=torch.tensor([T]))[:, :ref.shape[1]]
        reset_launches()
        tokens = ts.encode(wav)
        y = ts.decode(tokens)
        if on_card:
            torch.cuda.synchronize()
        launches = read_launches()
        tokens, y = tokens.gather(), y.gather()
        err = _rel_err(ts.decode(ref).gather(), ref_wav)
    stages = _seq_encoder_stage_diffs(model, wav, _seq_devices(device, shards))
    differ, control_differ = int((tokens != ref).sum()), int((control != ref).sum())
    expected = {"rvq_encode": 0, "lstm2": 0,
                **{k: shards * n if on_card else 0 for k, n in fused_stage_counts(model.config).items()}}
    row = dict(tokens=ref.numel(), tokens_differ=differ, tokens_differ_limit=control_differ,
               wav_rel_err=err, wav_limit=SEQ_LIMITS["bf16_wav_rel"], launches=launches,
               finite=bool(torch.isfinite(y.float()).all()), encoder_layers=stages)
    if on_card:
        row["ms"] = time_ms(lambda: ts.decode(ts.encode(wav)).gather(), iters)
        row["ms_unsharded"] = time_ms(lambda: model.decode(model.encode(wav)), iters)
    print(f"[sequence] {preset} bf16 {seconds:g} s on {shards} time shards: tokens differ {differ} of {ref.numel()} "
          f"(limit {control_differ}: what the unsharded model parts, padded to {bucket_seconds:g} s buckets and "
          f"encoded with its length), wav of the same tokens max abs diff / max |wav| {err:.3g} (limit "
          f"{SEQ_LIMITS['bf16_wav_rel']}), launches {launches} (expected {expected}), roundtrip "
          f"{row.get('ms', float('nan')):.3f} ms against {row.get('ms_unsharded', float('nan')):.3f} unsharded")
    print(f"[sequence] {preset} bf16 encoder layer by layer, sharded on the unsharded input against unsharded "
          f"(max abs diff): {stages}")
    if not (differ <= control_differ and err <= SEQ_LIMITS["bf16_wav_rel"] and launches == expected
            and row["finite"] and y.shape == ref_wav.shape and tokens.shape == ref.shape):
        raise AssertionError(f"sequence: {preset} bf16 on {shards} shards: {row}")
    del model
    return row


def _seq_spans(model, T: int, shards: int, unit: int, length: int) -> list:
    """The time blocks ``TimeShardedVQVAE`` cuts a ``T``-sample file into, in the
    steps of a layer with ``unit`` steps a latent frame and ``length`` steps."""
    from academicodec_tpu_torch.parallel.sequence import time_blocks

    blocks = time_blocks(model.frames_for(T), shards)
    return [(a * unit, b * unit) for a, b in blocks[:-1]] + [(blocks[-1][0] * unit, length)]


def _seq_encoder_stage_diffs(model, wav, devices) -> list:
    """Where a sharded HiFi-Codec encode parts from the unsharded one: each layer
    of the encoder run sharded on the unsharded run's own input to it, and the
    max abs difference of its output from the unsharded layer's: ``conv_pre``,
    each stage's strided conv (``ups``), its first GroupNorm alone (on the
    unsharded first resblock's output; wide stages only, K4 holds the narrow
    ones' statistics), the whole stage (``stage_forward``: K4, or the resblocks
    and GroupNorms), and ``conv_post``."""
    from academicodec_tpu_torch.nn.hifigan import lrelu
    from academicodec_tpu_torch.parallel import sequence

    enc, n, T = model.encoder, len(devices), wav.shape[-1]
    encs = [enc] * n

    def split(v, unit):
        return sequence.split_time(v, _seq_spans(model, T, n, unit, v.shape[-1]), devices)

    def diff(sharded, ref):
        return (sharded.gather().float() - ref.float()).abs().max().item()

    unit = model.hop_length
    with torch.no_grad():
        x = enc.conv_pre(wav[:, None])
        rows = [dict(layer="conv_pre", max_abs_diff=diff(sequence.conv1d([enc.conv_pre] * n, split(wav[:, None], unit)),
                                                          x))]
        for st, (u, _) in enumerate(enc.ups_cfg):
            v = lrelu(x)
            y = enc.ups[st](v)
            row = dict(layer=f"stage {st}", channels=y.shape[1], k4=enc.fused_stage(st),
                       ups=diff(sequence.conv1d([enc.ups[st]] * n, split(v, unit)), y))
            unit //= u
            if not enc.fused_stage(st):
                gn, r0 = enc.stage(st)[1][0], enc.stage(st)[0][0](y)
                r0s = split(r0, unit)
                row["group_norm"] = diff(gn(r0s, sequence.TimeBlocks(r0s)), gn(r0))
            x = enc.stage_forward(st, y)
            fn = sequence._encoder_stage_gn_fused if enc.fused_stage(st) else sequence._encoder_stage_unfused
            row["stage"] = diff(fn(encs, st, split(y, unit), None), x)
            rows.append(row)
        v = lrelu(x, 0.01)
        rows.append(dict(layer="conv_post", max_abs_diff=diff(sequence.conv1d([enc.conv_post] * n, split(v, unit)),
                                                               enc.conv_post(v))))
    return rows


def _seq_k4_stage(device, dtype, seconds: float, shards: int, iters: int, preset: str, overrides: dict) -> dict:
    """K4 as the sharded path runs it, at full width: ``preset``'s encoder stage 0
    (its input from one file of ``seconds``) over ``shards`` time shards of one
    device, cut as ``TimeShardedVQVAE`` cuts it. Each shard's pass 1 with its
    per-tile partials kept (``gn_tower_partials``) on its window
    (``sequence.k4_shard_tiles``) against its plain version on the same input:
    the chain outputs at :data:`TOWER_LIMITS` and the partials likewise (x max
    |plain|), and the partials against the plain per-tile moments of the
    kernel's own chain outputs (``k4_partials_rel`` x max |plain|);
    ``moments_reduce`` over the shards' owned tiles bitwise its plain version;
    the sharded stage (one launch a shard) bit for bit one launch over the
    whole sequence on the card (1e-5 on the CPU, whose plain sums follow the
    tensor's length). The interior shard's pass 1 is timed against its plain
    version and its bound (bf16)."""
    from academicodec_tpu_torch.parallel import sequence

    on_card = torch.device(device).type == "cuda"
    model = load_codec(preset, device=device, dtype=dtype, **overrides)
    enc = model.encoder
    if not enc.fused_stage(0):
        raise AssertionError(f"sequence: {preset}'s encoder stage 0 does not run K4")
    wav = seeded_wav(1, int(seconds * model.config.sampling_rate), device, seed=25).to(dtype)
    packed = enc.packed_tower(0)
    norms = enc.stage(0)[1]
    scs, gbs = torch.stack([g.weight for g in norms]), torch.stack([g.bias for g in norms])
    TT = resblock_ops.gn_tile(packed)
    with torch.no_grad():
        x = enc.ups[0](torch.nn.functional.leaky_relu(enc.conv_pre(wav[:, None]), 0.1))
        B, C, N = x.shape
        ref = resblock_ops.resblock_tower_gn(x, packed, None, scs, gbs, num_groups=C // 16)
        spans = _seq_spans(model, wav.shape[-1], shards, model.hop_length // enc.ups_cfg[0][0], N)
        xs = sequence.split_time(x, spans, _seq_devices(device, shards))
        reset_launches()
        got = sequence._encoder_stage_gn_fused([enc] * shards, 0, xs, None)
        if on_card:
            torch.cuda.synchronize()
        launches = read_launches()
        got = got.gather()
        halo = resblock_ops.tower_halo(enc.rks, enc.rds, enc.config.resblock)
        ranges, tiles = sequence.k4_shard_tiles(spans, N, halo, TT)
        errs, parts = dict(chains=0.0, partials=0.0, partials_own=0.0, max_abs_err=0.0), []
        for (lo, hi), (t_lo, t_hi) in zip(ranges, tiles):
            ext = x[..., lo:hi].contiguous()
            outs, part = resblock_ops.gn_tower_partials(ext, packed)
            plain_outs, plain_part = resblock_ops.gn_tower_partials_plain(ext, packed)
            errs["max_abs_err"] = max(errs["max_abs_err"], (outs.float() - plain_outs.float()).abs().max().item())
            errs["chains"] = max(errs["chains"], _rel_err(outs, plain_outs))
            errs["partials"] = max(errs["partials"], _rel_err(part, plain_part))
            errs["partials_own"] = max(errs["partials_own"],
                                       _rel_err(part, resblock_ops.tile_moments_plain(list(outs), TT)))
            parts.append(part[:, t_lo - lo // TT:t_hi - lo // TT])
        part = torch.cat(parts, dim=1)
        reduce_bitwise = torch.equal(resblock_ops.moments_reduce(part), resblock_ops.moments_reduce_plain(part))
    stage_diff = (got.float() - ref.float()).abs().max().item()
    expected = {"rvq_encode": 0, "lstm2": 0, "resblock_tower": 0, "resblock_tower_gn": shards if on_card else 0}
    tol = TOWER_LIMITS[dtype]
    row = dict(shape=[B, C, N], spans=spans, windows=ranges, tiles=tiles, TT=TT, tolerance=tol,
               partials_own_tolerance=SEQ_LIMITS["k4_partials_rel"], reduce_bitwise=reduce_bitwise,
               stage_max_abs_diff_vs_one_launch=stage_diff, launches=launches, **errs)
    print(f"[sequence] K4 sharded stage {preset} stage 0 {dtype} [{B},{C},{N}] over {shards} shards (windows "
          f"{ranges}, tiles {tiles} of {TT}): pass 1 against plain, chains {errs['chains']:.3g} and partials "
          f"{errs['partials']:.3g} of max |plain| (limit {tol}), partials against the plain moments of its own "
          f"outputs {errs['partials_own']:.3g} (limit {SEQ_LIMITS['k4_partials_rel']}); moments_reduce bitwise its "
          f"plain version: {reduce_bitwise}; the stage against one launch over the whole: max abs diff "
          f"{stage_diff:.3g} (limit {0 if on_card else 1e-5}); launches {launches} (expected {expected})")
    if not (errs["chains"] <= tol and errs["partials"] <= tol and errs["partials_own"] <= SEQ_LIMITS["k4_partials_rel"]
            and reduce_bitwise and stage_diff <= (0.0 if on_card else 1e-5) and launches == expected):
        raise AssertionError(f"sequence: K4's sharded stage disagrees ({dtype}): {row}")
    if on_card and dtype == torch.bfloat16:
        lo, hi = ranges[1]
        ext = x[..., lo:hi].contiguous()
        with torch.no_grad():
            row["ms"] = time_ms(lambda: resblock_ops.gn_tower_partials(ext, packed), iters)
            row["plain_ms"] = time_ms(lambda: resblock_ops.gn_tower_partials_plain(ext, packed), 2)
        ks, G, T1 = enc.rks, len(enc.rks), hi - lo
        taps = sum(k * len(resblock_ops.chain_conv_dilations(ds, "1")) for k, ds in zip(ks, enc.rds))
        n_part = B * -(-T1 // TT) * C * (G + G * (G + 1) // 2)
        row["bound_ms"], row["bound_by"] = bound(2.0 * B * T1 * C * C * taps,
                                                 2 * (B * C * T1 * (1 + G) + C * C * taps) + 4 * n_part,
                                                 PEAK_BF16_FLOPS)
        row["shard_shape"] = [B, C, T1]
        print(f"[sequence] K4 pass 1 with partials, interior shard [{B},{C},{T1}]: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    del model
    return row


def _seq_compress(device, shards: int, seconds, preset: str, overrides: dict) -> dict:
    """(c) ``cli.compress --sequence_parallel`` over ``shards`` time shards of one
    device against the same CLI without it, f32, on three files: ``seconds[0]``
    long, which the shards split into whole frames, ``seconds[1]`` and 7
    samples, which they cannot (uneven blocks and a ragged last shard), and
    one of fewer frames than shards (served unsharded). Blobs must be
    byte-identical."""
    from academicodec_tpu_torch.models.presets import SOUNDSTREAM_PRESETS

    import os
    import tempfile

    from academicodec_tpu_torch.cli import compress as compress_cli
    from academicodec_tpu_torch.data.wavio import write_wav

    on_card = torch.device(device).type == "cuda"
    model = load_codec(preset, device=device, **overrides)
    sr, hop = model.sample_rate, model.hop_length
    cfg = dict(SOUNDSTREAM_PRESETS[preset], **overrides)
    lengths = [int(round(seconds[0] * sr)), int(round(seconds[1] * sr)) + 7, 2 * hop - 7]
    wavs = [seeded_wav(1, n, "cpu", seed=23 + i)[0].numpy() for i, n in enumerate(lengths)]
    spread_codebooks(model, latent_frames(model, torch.from_numpy(wavs[0][None])))
    devs = ",".join(str(d) for d in _seq_devices(device, shards))
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "in"))
        for i, w in enumerate(wavs):
            write_wav(os.path.join(tmp, "in", f"w{i}.wav"), w, sr)
        pth = os.path.join(tmp, "m.pth")
        torch.save(model.state_dict(), pth)
        flags = ["--input", os.path.join(tmp, "in"), "--resume_path", pth, "--sr", str(sr), "--ratios",
                 *map(str, model.ratios), "--target_bandwidths", *map(str, model.target_bandwidths), "--n_filters",
                 str(cfg["n_filters"]), "--dimension", str(cfg["dimension"]), "--bins", str(model.bins),
                 "--target_bw", str(model.target_bandwidths[-1]), "--ecdc"]
        launches = {}
        for tag, extra in (("unsharded", ["--device", str(device)]),
                           ("sharded", ["--sequence_parallel", "--device", devs])):
            reset_launches()
            compress_cli.main(flags + extra + ["--output", os.path.join(tmp, tag)])
            if on_card:
                torch.cuda.synchronize()
            launches[tag] = read_launches()
        blobs = {tag: [open(os.path.join(tmp, tag, f"w{i}.ecdc"), "rb").read() for i in range(len(wavs))]
                 for tag in launches}
    same = [a == b for a, b in zip(blobs["sharded"], blobs["unsharded"])]
    # per file: K1 once a shard (once for the file served unsharded), K2 once in the encoder and once in the decoder
    frames = [-(-n // hop) for n in lengths]
    k1 = sum(shards if f >= shards else 1 for f in frames)
    expected = {"rvq_encode": k1 if on_card else 0, "lstm2": 2 * len(lengths) if on_card else 0,
                "resblock_tower": 0, "resblock_tower_gn": 0}
    print(f"[sequence] cli.compress {preset} f32, files of {list(lengths)} samples, --sequence_parallel --device "
          f"{devs}: blobs byte-identical {same} ({[len(b) for b in blobs['sharded']]} bytes), launches "
          f"{launches['sharded']} (expected {expected}; unsharded {launches['unsharded']})")
    if not (all(same) and launches["sharded"] == expected):
        raise AssertionError(f"sequence: cli.compress --sequence_parallel blobs {same}, launches {launches}")
    del model
    return dict(lengths=list(lengths), blobs_identical=same, launches=launches["sharded"],
                launches_unsharded=launches["unsharded"], blob_bytes=[len(b) for b in blobs["sharded"]])


def phase_sequence(device="cuda", seconds=60.0, shards=4, iters=3, hifi_seconds=60.0, bucket_seconds=10.0,
                   compress_seconds=(20.0, 13.37), encodec=None, hifi=None, hifi_bf16=True) -> dict:
    """Time-sharded serving (``parallel/sequence.py``) on one card, ``shards`` time
    shards on one device: (a) the flagship Encodec_24k_240d (``encodec``:
    overrides of its preset), one stream of ``seconds``, in f32 and bf16,
    through ``TimeShardedSoundStream`` on 1 and on ``shards`` shards against the
    unsharded model; (b) hificodec_24k_320d (``hifi``: overrides), one file of
    ``hifi_seconds`` through ``cli.extract_tokens --sequence_parallel`` against
    the CLI without it, exact and bucketed (f32), and through
    ``TimeShardedVQVAE`` in bf16, and K4's sharded stage at its width
    (:func:`_seq_k4_stage`, f32 and bf16 on the card); (c) ``cli.compress
    --sequence_parallel`` on three files (``compress_seconds`` and one of fewer
    frames than shards). Every run's launch counts are set to 0 just before
    it and read just after. ``hifi_bf16``: run (b) in bf16 too; a CPU
    rehearsal leaves it out, since the CPU build's bf16 ``conv1d`` with a
    stride and no padding (a block's halo'd window) misses by whole units
    (torch 2.13.0+cpu, oneDNN) where the same conv with padding does not.
    Limits: :data:`SEQ_LIMITS`."""
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    result = {"limits": SEQ_LIMITS, "shards": shards, "device": nvidia_smi() if on_card else "cpu"}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag, dtype in (("encodec_f32", torch.float32), ("encodec_bf16", torch.bfloat16)):
            result[tag] = _seq_encodec(device, dtype, seconds, shards, iters, FLAGSHIP, encodec or {})
        result["extract"] = _seq_extract(device, hifi_seconds, shards, bucket_seconds, HIFI, hifi or {})
        if hifi_bf16:
            result["hifi_bf16"] = _seq_hifi_bf16(device, hifi_seconds, shards, iters, HIFI, hifi or {}, bucket_seconds)
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))[:2 if hifi_bf16 else 1]:
            result[f"k4_stage_{tag}"] = _seq_k4_stage(device, dtype, hifi_seconds, shards, iters, HIFI, hifi or {})
        result["compress"] = _seq_compress(device, shards, compress_seconds, FLAGSHIP, encodec or {})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    result["wall_s"] = time.perf_counter() - t0
    print(f"[sequence] the phase {result['wall_s']:.1f} s ({result['device']})")
    return result


def probe_bounds() -> list:
    """The bounds of the probe's two chains (``int8_chain.chain_bounds``) at its
    four one-tile cases and its two decision shapes."""
    rows = [dict(C=C, TT=TT, **int8_chain.chain_bounds(1, C, TT)) for C, TT in int8_chain.CASES]
    rows += [dict(shape=tag, B=B, C=C, T=T, **int8_chain.chain_bounds(B, C, T)) for tag, B, C, T in int8_chain.SHAPES]
    return rows


PROBE_P1_TOL = 2e-2   # P1 vs plain, x max |plain| (K3's bf16 limit, TOWER_LIMITS)
PROBE_I8_REL_L2 = 0.12  # P2 vs the f32 reference chain (the port's int8 limit)


def _probe_kernel(res: dict, launches: int, name: str, fmt: str, replaces: str, tolerance: str, err_key: str) -> dict:
    """One kernel's entry of the ``kernels`` line: times summed over the two
    decision shapes (one chain over each of K3's stage shapes)."""
    shapes, rows = res["shapes"], res["cases"] + res["shapes"]

    def total(key):
        vals = [s[key] for s in shapes]
        return None if any(v is None for v in vals) else sum(vals)

    return dict(
        name=name, route="cuda", source="academicodec_tpu_torch/csrc/chain.cu", replaces=replaces,
        launches=launches, max_abs_err=max(r[err_key] for r in rows), tolerance=tolerance,
        ms=total(f"{fmt}_ms"), plain_ms=total(f"plain_{fmt}_ms"), bound_ms=total(f"bound_{fmt}_ms"),
        bound_by="operations" if all(s[f"bound_{fmt}_by"] == "operations" for s in shapes) else "bytes",
        library_ms=total(f"library_{fmt}_ms"),
        per_shape={s["shape"]: {k: s[k] for k in (f"{fmt}_ms", f"plain_{fmt}_ms", f"bound_{fmt}_ms",
                                                  f"library_{fmt}_ms")} for s in shapes},
        per_tile=[{k: c[k] for k in ("C", "TT", f"{fmt}_ms", f"bound_{fmt}_ms")} for c in res["cases"]],
        note="ms, plain_ms, bound_ms and library_ms sum the two decision shapes (s2 [8,64,120000] + s3 "
             "[8,32,240000]); library: " + ("6 x cuDNN bf16 conv1d + bias + lrelu" if fmt == "bf16" else
                                           "6 x ops/int8.conv1d_w8a8 (im2col + cuBLASLt int8 GEMM) + lrelu"),
    )


def chain_geometry(B: int, C: int, T: int, P: int = 6, on_card: bool = False) -> dict:
    """P1/P2's launch geometry at ``[B, C, T]`` as the wrapper picks it
    (``chain.chain_cols``, ``chain.ChainLayout``; the SMs of card 0 on the card,
    the H100's 132 off it): output time steps a block (TT), B columns a consumer
    warpgroup computes a conv (wgmma halves of N 128), phases stacked in M,
    blocks; on the card also each chain's ring stages and the dynamic shared
    memory its launch sets, read from the built library, whose window rows must
    be the wrapper's."""
    sms = chain_ops._sm_count(0) if on_card else chain_ops.H100_SMS
    cols = chain_ops.chain_cols(B, T, P, C, sms)
    lay = chain_ops.ChainLayout(C, 2, P, cols)
    geo = dict(TT=lay.tile, n_per_warpgroup=cols, warpgroups=chain_ops.CONSUMERS, phases=lay.phases,
               blocks=lay.blocks(B, T), sms=sms)
    if on_card:
        for name, int8 in (("bf16", False), ("i8", True)):
            kg = chain_ops.kernel_geometry(int8, C, cols)
            if kg["rows"] != lay.rows:
                raise AssertionError(f"probe_chain: the kernel's window has {kg['rows']} rows, "
                                     f"the wrapper's {lay.rows}")
            geo.update({f"stages_{name}": kg["stages"], f"smem_{name}": kg["smem_bytes"]})
    return geo


def chain_sass_counts() -> dict:
    """Each chain kernel's tensor-core instructions in the built library, read
    with ``cuobjdump --dump-sass``: wgmma (``HGMMA`` bf16, ``IGMMA`` int8) and
    ``mma.sync`` (``HMMA``, ``IMMA``), per chain and template ``C<c>/N<columns>``."""
    path, _ = kernel_build.build()
    tool = os.path.join(os.path.dirname(kernel_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(path)], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = re.search(r"chain_kernelI(a|13__nv_bfloat16)Li(\d+)ELi(\d+)E", m.group(1))
            key = None
            if fn:
                chain = "conv_chain_i8" if fn.group(1) == "a" else "conv_chain_bf16"
                key = (chain, f"C{fn.group(2)}/N{fn.group(3)}")
                counts.setdefault(chain, {})[key[1]] = dict.fromkeys(("HGMMA", "IGMMA", "HMMA", "IMMA"), 0)
            continue
        if key is not None:
            op = re.search(r"\b(HGMMA|IGMMA|HMMA|IMMA)\.", line)
            if op:
                counts[key[0]][key[1]][op.group(1)] += 1
    return counts


def phase_probe_chain(device="cuda", tiny: bool = False) -> dict:
    """The int8 decision probe (``probes/int8_chain.py``) as its entry point runs
    it, with every count set to 0 just before and read just after: P1 and P2
    at the probe's four one-tile cases and at the decision shapes s2 and s3,
    timed on the card, and the decision. Each kernel's output is held against
    its plain version on the same inputs (P1 within ``PROBE_P1_TOL`` of max
    |plain|, P2 bit for bit) and P2 against the f32 reference chain (relative
    L2 within ``PROBE_I8_REL_L2``); K1-K4 launch no time. First the chains'
    launch geometry at each case and shape, and on the card their tensor-core
    instructions in the built library: each chain issues ``wgmma`` and no
    ``mma.sync``. ``tiny``: the probe's ``--tiny`` sizes (a CPU rehearsal)."""
    on_card = torch.device(device).type == "cuda"
    cases = int8_chain.TINY_CASES if tiny else int8_chain.CASES
    geometry = {f"C{C}/TT{TT}": chain_geometry(1, C, TT, on_card=on_card) for C, TT in cases}
    geometry.update({tag: chain_geometry(B, C, T, on_card=on_card) for tag, B, C, T in
                     (int8_chain.TINY_SHAPES if tiny else int8_chain.SHAPES)})
    print(f"[probe_chain] geometry {json.dumps(geometry)}")
    sass = chain_sass_counts() if on_card else None
    if on_card:
        print(f"[probe_chain] SASS tensor-core instructions {json.dumps(sass)}")
        wgmma = {k: sum(c["HGMMA"] + c["IGMMA"] for c in v.values()) for k, v in sass.items()}
        mma_sync = sum(c["HMMA"] + c["IMMA"] for v in sass.values() for c in v.values())
        if sorted(wgmma) != ["conv_chain_bf16", "conv_chain_i8"] or not all(wgmma.values()) or mma_sync:
            raise AssertionError(f"probe_chain: a chain kernel issues no wgmma, or mma.sync: {sass}")
    reset_launches()
    profiling.reset(*PROBE_COUNTERS.values())
    t0 = time.perf_counter()
    res = int8_chain.run(device, tiny=tiny, out=lambda row: print(f"[probe_chain] {json.dumps(row)}", flush=True))
    if on_card:
        torch.cuda.synchronize()
    launches = {**read_launches(), **read_probe_launches()}
    rows = res["cases"] + res["shapes"]
    misses = [r for r in rows if not (r["p1_vs_plain"] <= PROBE_P1_TOL and r["p2_bitwise"]
                                      and r["rel_l2_i8"] <= PROBE_I8_REL_L2)]
    expected = int8_chain.launches_per_kernel(len(res["cases"]), len(res["shapes"])) if on_card else 0
    counted = (all(launches[k] == expected for k in ("conv_chain_bf16", "conv_chain_i8"))
               and not any(read_launches().values()))
    wall = time.perf_counter() - t0
    print(f"[probe_chain] P1 against plain: at most {max(r['p1_vs_plain'] for r in rows):.3g} of max |plain| "
          f"(limit {PROBE_P1_TOL}); P2 bitwise its plain version in {sum(r['p2_bitwise'] for r in rows)} of "
          f"{len(rows)} runs, relative L2 against the f32 reference at most "
          f"{max(r['rel_l2_i8'] for r in rows):.4g} (limit {PROBE_I8_REL_L2}); launches {launches} (expected "
          f"{expected} each); decision: {res['decision']}; the phase {wall:.1f} s ({res['device']})")
    if misses or not counted:
        raise AssertionError(f"probe_chain: {len(misses)} runs miss their limits ({misses[:2]}), launches {launches}")
    kernels = [
        _probe_kernel(res, launches["conv_chain_bf16"], "conv_chain_bf16", "bf16",
                      "benchmarks/pallas_int8_probe.py:110", f"{PROBE_P1_TOL} x max|plain|", "p1_max_abs_vs_plain"),
        _probe_kernel(res, launches["conv_chain_i8"], "conv_chain_i8", "i8",
                      "benchmarks/pallas_int8_probe.py:116", "bitwise", "p2_max_abs_vs_plain"),
    ]
    for k in kernels:
        k.update(sass=None if sass is None else sass[k["name"]])
    return dict(res, launches=launches, kernels=kernels, geometry=geometry, wall_s=wall)


DAC = "dac_44k_512d"
# the kernel's sine is the hardware one on an argument reduced to [-pi/2, pi/2]: ~4e-7 from
# torch's, times 1 / alpha (<= 5); 1e-5 of max(1, |y|) leaves that room (tests/test_torch_dac_cuda.py)
SNAKE_F32_TOL = 1e-5
SNAKE_ULPS = 1  # 16-bit: the f32 result rounded, or one ulp off it


def snake_library(h, alpha, bias, residual):
    """The epilogue as eager aten ops in the activations' dtype, as DAC's own code runs
    it after a conv that adds its bias: the bias add, the residual add and ``Snake1d``'s
    ``x + (alpha + 1e-9).reciprocal() * sin(alpha * x).pow(2)``."""
    shape = (1, -1) + (1,) * (h.dim() - 2)
    x = h if bias is None else h + bias.to(h.dtype).view(shape)
    if residual is not None:
        x = x + residual
    a = alpha.to(h.dtype).reshape(shape)
    return x + (a + snake_ops.ALPHA_EPS).reciprocal() * torch.sin(a * x).pow(2)


def _snake_distance(y: torch.Tensor, want: torch.Tensor) -> dict:
    """``y`` against the plain f32 result ``want``: the largest error over max(1, |want|),
    and in 16 bits the largest distance in ulps from ``want`` rounded; ``ok`` where every
    element is within :data:`SNAKE_ULPS` or, near 0 (where the sine's ~4e-7 exceed an ulp),
    within the f32 tolerance."""
    rel = (y.float() - want).abs_().div_(want.abs().clamp_(min=1.0))
    if y.dtype == torch.float32:
        worst = rel.max().item()
        return dict(rel=worst, ulps=0, near_zero=0, ok=worst <= SNAKE_F32_TOL)
    ulps = (y.view(torch.int16).int() - want.to(y.dtype).view(torch.int16).int()).abs_()
    over = ulps > SNAKE_ULPS
    far = int((over & (rel > SNAKE_F32_TOL)).sum())
    return dict(rel=rel.max().item(), ulps=int(ulps[~over].max()) if bool((~over).any()) else 0,
                near_zero=int(over.sum()), ok=far == 0)


def _checked_snake(records: list):
    """``ops/cuda/snake.snake`` that also holds each call against ``snake_plain`` on the same
    tensors (f32 math, f32 result) and appends the call's layout and distance to ``records``."""
    real = snake_ops.snake

    def checked(h, alpha, bias=None, residual=None, keep_sum=False, frames=None):
        y, s = real(h, alpha, bias, residual, keep_sum, frames)
        f32 = [None if t is None else t.float() for t in (h, residual)]
        want, want_s = snake_ops.snake_plain(f32[0], alpha, bias, f32[1], keep_sum, frames)
        T = h.shape[-1]
        rec = dict(shape=tuple(h.shape), hs=h.stride(0), rs=None if residual is None else residual.stride(0),
                   bias=bias is not None, keep_sum=keep_sum, frames=y.shape[-1], dtype=h.dtype,
                   **_snake_distance(y, want))
        rec["sum_exact"] = (s is None) == (not keep_sum) and (s is None or torch.equal(s, want_s.to(h.dtype)))
        rec["zeros_past_T"] = y.shape[-1] == T or not bool(y[..., T:].any())
        records.append(rec)
        del want, want_s, f32
        return y, s

    return checked


def _unframed_run(self, p):
    """``nn/dac.ResidualUnit.run`` with the dilated conv's input written ``T`` frames long,
    so that ``conv_phases`` pads it and crops its output: the towers without ``frames``."""
    snake1, dilated, snake2, pointwise = self.block
    y, x = snake1.epilogue(p, keep_sum=True)
    y, _ = snake2.epilogue(dac_nn.Pending(dilated(y, add_bias=False), dilated.bias))
    return dac_nn.Pending(pointwise(y, add_bias=False), pointwise.bias, x)


def _snake_operands(rec: dict, device, seed: int):
    """Seeded operands in ``rec``'s layout: ``h`` (and the residual) with its batch-row
    stride, so a channels-last ``h`` is the view of the first ``T`` frames of a longer row."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape, dtype = rec["shape"], rec["dtype"]
    B, C, T = shape[0], shape[1], shape[-1]

    def like(stride0, scale):
        if len(shape) == 3:
            return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)
        rows = (torch.randn((B, stride0 // C, C), generator=g, device=device) * scale).to(dtype)
        return rows.transpose(1, 2).unsqueeze(2)[..., :T]

    h = like(rec["hs"], 30.0)
    r = None if rec["rs"] is None else like(rec["rs"], 3.0)
    alpha = 5.0 ** (torch.rand((1, C, 1), generator=g, device=device) * 2 - 1)
    bias = torch.randn(C, generator=g, device=device) if rec["bias"] else None
    return h, alpha, bias, r


def _snake_times(records: list, device, iters: int) -> dict:
    """The kernel, its plain version and the eager aten chain timed on seeded operands of
    each distinct launch of one call, summed over the call; the bound from the bytes and
    operations each launch moves (:func:`~academicodec_tpu_torch.probes.int8_chain.bound`)."""
    groups = {}
    for rec in records:
        key = (rec["shape"], rec["hs"], rec["rs"], rec["bias"], rec["keep_sum"], rec["frames"], rec["dtype"])
        groups.setdefault(key, [rec, 0])[1] += 1
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    flops = nbytes = 0.0
    per_launch = []
    for i, (rec, count) in enumerate(groups.values()):
        h, alpha, bias, r = _snake_operands(rec, device, i)
        n, item = h.numel(), h.element_size()
        work = (8.0 * n, item * (n * (1 + (r is not None) + rec["keep_sum"]) + h.shape[0] * h.shape[1] * rec["frames"]))
        ms = time_ms(lambda: snake_ops.snake(h, alpha, bias, r, rec["keep_sum"], rec["frames"]), iters)
        plain = time_ms(lambda: snake_ops.snake_plain(h, alpha, bias, r, rec["keep_sum"], rec["frames"]), 2)
        lib = time_ms(lambda: snake_library(h, alpha, bias, r), 2)
        b_ms, _ = bound(*work, PEAK_F32_FLOPS)
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b_ms)):
            total[k] += count * v
        flops, nbytes = flops + count * work[0], nbytes + count * work[1]
        per_launch.append(dict(shape=list(rec["shape"]), residual=r is not None, keep_sum=rec["keep_sum"],
                               frames=rec["frames"], launches=count, ms=ms, bound_ms=b_ms,
                               roofline=100.0 * b_ms / ms))
        del h, r
    total["bound_by"] = bound(flops, nbytes, PEAK_F32_FLOPS)[1]
    total["gbytes"] = nbytes / 1e9
    return dict(total, per_launch=per_launch)


def phase_snake(device="cuda", batch=16, seconds=10.0, dtypes=(torch.bfloat16, torch.float16, torch.float32),
                small_batch=4, iters=5, seed=0, **overrides) -> dict:
    """The Snake epilogue kernel (``csrc/snake.cu``) on the DAC main path
    (``load_codec("dac_44k_512d")``, seeded weights, alphas log-uniform on [0.2, 5]).
    One bf16 roundtrip of ``batch`` x ``seconds`` (the benchmark cell's 16 x 10 s) with
    ``snake.launches`` set to 0 just before and read just after (one a Snake: 58). Then
    a roundtrip in each of ``dtypes`` (bf16 at ``batch``, the others at ``small_batch``)
    with every epilogue call held against ``snake_plain`` on its own tensors: the
    channels-last route's strided rows and zero frames past ``T`` in 16 bits, ``[B, C,
    T]`` in f32; f32 within 1e-5 of max(1, |y|), 16 bits within one ulp of the f32
    result rounded, the sums exact. On the card: each distinct launch of the bf16 call
    timed as the kernel, its plain version and the eager aten chain, summed over the
    call, against the bound of its bytes; and the bf16 roundtrip timed with and without
    ``frames`` (the pad and crop copies of ``conv_phases`` that ``frames`` spares),
    alternating. ``overrides``: the preset's widths (a CPU rehearsal)."""
    on_card = torch.device(device).type == "cuda"
    results, records = {}, {}

    def model_in(dtype):
        model = load_codec(DAC, device=device, dtype=dtype, seed=seed, **overrides)
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, dac_nn.Snake1d):
                    m.alpha.copy_(5.0 ** (torch.rand(m.alpha.shape, generator=g) * 2 - 1))
        return model

    model = model_in(torch.bfloat16 if on_card else torch.float32)
    length = int(round(seconds * model.sample_rate))
    wav = seeded_wav(batch, length, device)
    frames = model.frames_for(length)
    snakes = sum(isinstance(m, dac_nn.Snake1d) for m in model.modules())  # 58 at the published widths
    profiling.reset("snake.launches")
    codes = model.encode(wav)
    out = model.decode(codes)
    if on_card:
        torch.cuda.synchronize()
    launches = profiling.total("snake.launches").count
    expected = snakes if on_card else 0
    print(f"[snake] {DAC} {model.dtype} {tuple(wav.shape)}: codes {tuple(codes.shape)}, wav {tuple(out.shape)}, "
          f"snake.launches {launches} (expected {expected})")
    if launches != expected or tuple(codes.shape) != (model.n_q, batch, frames) or \
            not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"snake: {launches} launches, codes {tuple(codes.shape)}, finite output expected")
    results["launches"] = launches

    for dtype in dtypes:
        m = model if dtype == model.dtype else model_in(dtype)
        x = wav if dtype == model.dtype else wav[:small_batch]
        recs = records[dtype] = []
        orig = snake_ops.snake
        snake_ops.snake = _checked_snake(recs)
        try:
            m.decode(m.encode(x))
        finally:
            snake_ops.snake = orig
        if m is not model:
            del m
        misses = [r for r in recs if not (r["ok"] and r["sum_exact"] and r["zeros_past_T"])]
        name = str(dtype).replace("torch.", "")
        results[name] = dict(
            batch=x.shape[0], calls=len(recs), max_rel=max(r["rel"] for r in recs),
            max_ulps=max(r["ulps"] for r in recs), near_zero=sum(r["near_zero"] for r in recs),
            channels_last=sum(len(r["shape"]) == 4 for r in recs),
            frames_past_T=sum(r["frames"] > r["shape"][-1] for r in recs),
            strided_rows=sum(len(r["shape"]) == 4 and r["hs"] != r["shape"][1] * r["shape"][-1] for r in recs))
        print(f"[snake] {name} x{x.shape[0]}: {json.dumps(results[name])}")
        if len(recs) != snakes or misses:
            raise AssertionError(f"snake: {name}: {len(recs)} calls, {len(misses)} miss ({misses[:2]})")

    if on_card:
        results["times"] = _snake_times(records[torch.bfloat16], device, iters)
        t = results["times"]
        print(f"[snake] a call's {launches} launches: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"eager aten {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}, "
              f"{t['gbytes']:.2f} GB): {100 * t['bound_ms'] / t['ms']:.1f}% of it")
        framed = model.decode(model.encode(wav))
        runs = {"frames": [], "no_frames": []}
        original = dac_nn.ResidualUnit.run
        try:
            for _ in range(2):
                for tag in runs:
                    dac_nn.ResidualUnit.run = original if tag == "frames" else _unframed_run
                    runs[tag].append(time_ms(lambda: model.decode(model.encode(wav)), iters))
            unframed = model.decode(model.encode(wav))
        finally:
            dac_nn.ResidualUnit.run = original
        results["frames_ab"] = dict(
            runs, wav_max_abs_diff=float((framed.float() - unframed.float()).abs().max()),
            saved_ms=statistics.mean(runs["no_frames"]) - statistics.mean(runs["frames"]))
        print(f"[snake] roundtrip ms with frames {runs['frames']}, without (conv_phases pads and crops) "
              f"{runs['no_frames']}: {results['frames_ab']['saved_ms']:.3f} ms a call saved; wav "
              f"{results['frames_ab']['wav_max_abs_diff']:.3g} apart")
    return results


def snake_kernel_entry(res: dict) -> dict:
    """The Snake kernel's entry of the ``kernels`` line: a DAC bf16 roundtrip's launches summed."""
    t = res["times"]
    return dict(
        name="snake", route="cuda", source="academicodec_tpu_torch/csrc/snake.cu", replaces=None,
        launches=res["launches"], max_abs_err=None,
        max_rel_err={k: res[k]["max_rel"] for k in ("bfloat16", "float16", "float32") if k in res},
        max_ulps={k: res[k]["max_ulps"] for k in ("bfloat16", "float16") if k in res},
        tolerance=f"f32 {SNAKE_F32_TOL} x max(1,|y|); 16-bit {SNAKE_ULPS} ulp of the f32 result rounded",
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], frames_saved_ms=res["frames_ab"]["saved_ms"],
        note="ms, plain_ms, bound_ms and library_ms sum one dac_44k_512d bf16 roundtrip's 58 launches "
             "(16 x 10 s); library: bias add + residual add + DAC's Snake1d in eager aten, bf16",
    )


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
    snake = phase_snake(device)
    stream = phase_stream(device)
    stream_hifi = phase_stream_hifi(device)
    stream_check = phase_stream_check(device)
    compress = phase_compress(device)
    extract = phase_extract(device)
    lm = phase_lm(device)
    int8 = phase_int8(device)
    layer_opts = phase_layer_opts(device)
    train = phase_train(device)
    train_hifi = phase_train_hifi(device)
    train_lm = phase_train_lm(device)
    evaluate = phase_evaluate(device)
    native = phase_native_loader({"train_encodec": train["f32"]["launches_step"],
                                  "train_hificodec": train_hifi["f32"]["launches_step"]}, device)
    parallel = phase_parallel(device)
    sequence = phase_sequence(device)
    outside = read_probe_launches()  # P1/P2 over every phase above: none is theirs
    print(f"[probe_chain] P1/P2 launches over every serving and training phase: {outside} (expected 0)")
    if any(outside.values()):
        raise AssertionError(f"probe_chain: P1/P2 launched outside the probe: {outside}")
    probe = phase_probe_chain(device)
    p1, p2 = probe.pop("kernels")
    for k in (p1, p2):
        k["launches_serving_and_training"] = outside[k["name"]]
    k1["launches"] = main_path["launches"]["rvq_encode"]
    k2["launches"] = main_path["launches"]["lstm2"]
    for k, name in ((k1, "rvq_encode"), (k2, "lstm2")):
        k["launches_per_stream_chunk"] = stream["launches_per_chunk"][name]
        k["launches_compress_roundtrip"] = compress["launches"][name]
        k["launches_lm_compress_roundtrip"] = lm["launches"][name]
        k["launches_train_step"] = train["f32"]["launches_step"][name]
        k["launches_train_init_step"] = train["f32"]["launches_init_step"][name]
        k["launches_train_lm_step"] = train_lm["launches_step"][name]
        k["launches_evaluate_compress"] = evaluate["encodec"]["launches"][name]
        k["launches_native_loader_train_steps"] = [s[name] for s in native["train_encodec"]["launches_steps"]]
        k["launches_train_dp_init_step"] = parallel["world1"]["encodec"]["launches_parallel"][0][name]
        k["launches_train_dp_step"] = parallel["world1"]["encodec"]["launches_parallel"][-1][name]
        k["launches_dp_compress"] = parallel["serving"]["compress_parallel_launches"][name]
        k["launches_sequence_roundtrip"] = sequence["encodec_bf16"]["4 shards"]["launches"][name]
        k["launches_sequence_compress"] = sequence["compress"]["launches"][name]
    k1.update(train["k1_shapes"])
    k2.update(train["k2_shapes"])
    k3["launches"] = hifi["launches"]["resblock_tower"]
    k3["launches_fused_pre"] = hifi_pre["launches"]["resblock_tower"]
    k3["launches_extract"] = extract["launches"]["resblock_tower"]
    k3["launches_int8_roundtrip"] = int8["launches"]["resblock_tower"]
    k4["launches"] = hifi["launches"]["resblock_tower_gn"]
    k4["launches_extract"] = extract["launches"]["resblock_tower_gn"]
    k4["launches_int8_roundtrip"] = int8["launches"]["resblock_tower_gn"]
    for k, name in ((k3, "resblock_tower"), (k4, "resblock_tower_gn")):
        k["launches_train_hifi_step"] = train_hifi["f32"]["launches_step"][name]
        k["launches_train_hifi_eval"] = train_hifi["f32"]["launches_eval"][name]
        k["launches_evaluate_extract"] = evaluate["hificodec"]["launches"][name]
        k["launches_native_loader_train_hifi_steps"] = [
            s[name] for s in native["train_hificodec"]["launches_steps"]]
        k["launches_train_hifi_dp_step"] = parallel["world1"]["hifi"]["launches_parallel"][-1][name]
        k["launches_dp_extract"] = parallel["serving"]["extract_parallel_launches"][name]
        k["launches_sequence_extract"] = sequence["extract"]["exact"]["launches"][name]
        tag = "k3" if k is k3 else "k4"
        k["train_hifi_shapes"] = {c: v for c, v in train_hifi["towers"].items() if c.startswith(tag)}
    shard = sequence["k4_stage_bf16"]
    k4.update(ms_shard=shard["ms"], plain_ms_shard=shard["plain_ms"], bound_ms_shard=shard["bound_ms"],
              max_abs_err_shard=shard["max_abs_err"],
              launches_sequence_stage=shard["launches"]["resblock_tower_gn"])
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
    print(f"[lm] {json.dumps(lm)}")
    print(f"[int8] {json.dumps(int8)}")
    print(f"[layer_opts] {json.dumps(layer_opts)}")
    print(f"[train] {json.dumps(train)}")
    print(f"[train_hifi] {json.dumps({k: v for k, v in train_hifi.items() if k != 'towers'})}")
    print(f"[train_lm] {json.dumps(train_lm)}")
    print(f"[evaluate] {json.dumps(evaluate)}")
    print(f"[native_loader] {json.dumps(native)}")
    print(f"[parallel] {json.dumps(parallel)}")
    print(f"[sequence] {json.dumps(sequence)}")
    print(f"[probe_bounds] {json.dumps(probe_bounds())}")
    print(f"[probe_chain] {json.dumps(probe)}")
    print(f"[snake] {json.dumps(snake)}")
    print(json.dumps({"kernels": [k1, k2, k3, k4, snake_kernel_entry(snake), p1, p2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
