"""The int8 decision probe on the card: ``benchmarks/pallas_int8_probe.py``'s
``run_case`` / ``main`` with P1 and P2 (``ops/cuda/chain.py``) in place of its
two Pallas kernels.

The question: does a fused int8 resblock tower pay? The probe's rule
(its docstring): wire int8 towers only if the bf16 chain takes 1.25x the
W8A8 chain's time or more at the s2/s3 shapes. Both chains are 6 convs of
k 7 over bf16 input, with seeded numpy inputs at the probe's scales (x ~
N(0, 0.5^2), W ~ N(0, 1 / 7C), b ~ N(0, 0.01^2)) and the probe's
calibration (``chain.calibrate``).

- The probe's four cases ``(C, TT)``: one ``[C, TT]`` tile, timed as 16 serial
  launches (each feeding the next, as the probe's ``fori_loop``) between two
  CUDA events, divided by 16, with the probe's keys (``C, TT, bf16_ms, i8_ms,
  ratio, err_bf16, err_i8``: errors are max |out - ref| against the f32
  reference chain) and each kernel's bound. A tile is a few microseconds of
  work, so these are launch-bound on the card.
- The two decision shapes, K3's stage shapes: s2 ``[8, 64, 120000]`` and s3
  ``[8, 32, 240000]``, each chain the mean of 10 calls after a warm-up, beside
  the bounds, the plain versions and two library yardsticks: 6 x cuDNN bf16
  ``F.conv1d(padding=3)`` + bias + lrelu for P1, 6 x ``ops/int8.conv1d_w8a8``
  (quantize, im2col, cuBLASLt's int8 GEMM, dequantize, the port's int8 route)
  + lrelu for P2.

Every row also holds each kernel's output against its plain version on the
same inputs: P1's max |kernel - plain| over max |plain|, P2 bit for bit, and
P2's relative L2 error against the f32 reference. The last line gives the
decision: ``"wire int8 towers"`` if the ratio is at least 1.25 at both
shapes, else ``"keep bf16 towers"``.

    python -m academicodec_tpu_torch.probes.int8_chain [--device cuda|cpu] [--tiny]

It runs on the card unless ``--device cpu`` is given; there the plain
versions run and nothing is timed (every ``ms`` is null and the decision is
not taken). ``--tiny`` shrinks every case and shape to a few hundred frames.
TF32 is off while it runs (the f32 reference keeps its f32 weights).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from academicodec_tpu_torch.ops import int8 as int8_ops
from academicodec_tpu_torch.ops.cuda import chain

N_CONVS = 6
N_REP = 16
RATIO_RULE = 1.25
CASES = ((32, 8192), (64, 8192), (32, 4096), (64, 4096))
SHAPES = (("s2", 8, 64, 120000), ("s3", 8, 32, 240000))
TINY_CASES = ((32, 64), (64, 64), (32, 40), (64, 40))
TINY_SHAPES = (("s2", 2, 64, 300), ("s3", 2, 32, 600))
SHAPE_ITERS = 10
# NVIDIA H100 SXM data-sheet peaks (dense), at its full 700 W power limit; the
# bounds of chip_smoke.py read them from here too
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def bound(ops: float, nbytes: float, peak: float):
    """Least time (ms) the card could take for ``ops`` operations at ``peak``
    and ``nbytes`` moved once, and which of the two bounds it."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_inputs(C: int, T: int, batch: Optional[int] = None, seed: int = 0, device="cpu"):
    """Seeded ``x [C, T]`` (or ``[batch, C, T]``) bf16, ``w [6, C, 7C]`` and ``b [6,
    C, 1]`` f32 at the probe's scales."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, T) if batch is None else (batch, C, T), dtype=np.float32) * np.float32(0.5)
    w = rng.standard_normal((N_CONVS, C, 7 * C), dtype=np.float32) * np.float32(1.0 / np.sqrt(7 * C))
    b = rng.standard_normal((N_CONVS, C, 1), dtype=np.float32) * np.float32(0.01)
    return (torch.from_numpy(x).to(device).to(torch.bfloat16), torch.from_numpy(w).to(device),
            torch.from_numpy(b).to(device))


def chain_bounds(B: int, C: int, T: int, P: int = N_CONVS) -> dict:
    """Least time of each chain on the H100 (ms) and what bounds it: ``2 P C 7C
    B T`` operations at the bf16 (P1) or int8 (P2) peak, against the bytes of
    the bf16 input and output, the weights (bf16; int8 with f32 scales), the f32
    biases and P2's activation scales, each moved once."""
    ops = 2.0 * P * C * 7 * C * B * T
    io = 2 * 2 * B * C * T
    out = {}
    for name, peak, nbytes in (("bf16", PEAK_BF16_FLOPS, io + 2 * P * 7 * C * C + 4 * P * C),
                               ("i8", PEAK_INT8_OPS, io + P * 7 * C * C + 8 * P * C + 4 * P)):
        out[f"bound_{name}_ms"], out[f"bound_{name}_by"] = bound(ops, nbytes, peak)
    out.update(ops=ops)
    return out


def _events_ms(fn: Callable[[], object], iters: int, on_card: bool, warmup: int = 1) -> Optional[float]:
    """Mean device ms of ``fn`` from CUDA events around ``iters`` calls after a
    warm-up; off the card ``fn`` runs once and no time is taken (None)."""
    if not on_card:
        fn()
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _serial(f, x, ops):
    """The probe's ``rep``: ``N_REP`` applications, each on the last one's output."""
    def run():
        v = x
        for _ in range(N_REP):
            v = f(v, ops)
        return v
    return run


def _ratio(a: Optional[float], b: Optional[float]) -> Optional[float]:
    return None if a is None or b is None else a / b


def _compare(x, ops16, ops8, cal) -> dict:
    """Both kernels once on ``x``, each against its plain version and both
    against the f32 reference."""
    ref = cal["ref"].float()
    out16, out8 = chain.conv_chain_bf16(x, ops16).float(), chain.conv_chain_i8(x, ops8).float()
    plain16 = chain.conv_chain_bf16_plain(x, *ops16.raw).float()
    plain8 = chain.conv_chain_i8_plain(x, *ops8.raw).float()
    d16 = (out16 - plain16).abs().max().item()
    return dict(
        err_bf16=(out16 - ref).abs().max().item(), err_i8=(out8 - ref).abs().max().item(),
        rel_l2_i8=((out8 - ref).norm() / ref.norm()).item(),
        p1_max_abs_vs_plain=d16, p1_vs_plain=d16 / plain16.abs().max().item(),
        p2_max_abs_vs_plain=(out8 - plain8).abs().max().item(), p2_bitwise=bool(torch.equal(out8, plain8)),
    )


def _operands(x, w, b):
    cal = chain.calibrate(x, w, b)
    ops16 = chain.pack_chain_bf16(w.to(torch.bfloat16), b)
    ops8 = chain.pack_chain_i8(cal["wq"], cal["ws"], b, cal["s_act"])
    return cal, ops16, ops8


def run_case(C: int, TT: int, device) -> dict:
    """One of the probe's cases: one ``[C, TT]`` tile."""
    on_card = torch.device(device).type == "cuda"
    x, w, b = make_inputs(C, TT, None, 0, device)
    cal, ops16, ops8 = _operands(x, w, b)
    row = dict(C=C, TT=TT)
    row.update(_compare(x, ops16, ops8, cal))
    t16 = _events_ms(_serial(chain.conv_chain_bf16, x, ops16), 1, on_card)
    t8 = _events_ms(_serial(chain.conv_chain_i8, x, ops8), 1, on_card)
    row.update(bf16_ms=None if t16 is None else t16 / N_REP, i8_ms=None if t8 is None else t8 / N_REP)
    row["ratio"] = _ratio(row["bf16_ms"], row["i8_ms"])
    row.update(chain_bounds(1, C, TT))
    return row


def run_shape(tag: str, B: int, C: int, T: int, device, iters: int = SHAPE_ITERS, plain_iters: int = 2) -> dict:
    """One decision shape ``[B, C, T]``: both kernels, their plain versions and
    the library yardsticks."""
    on_card = torch.device(device).type == "cuda"
    x, w, b = make_inputs(C, T, B, 0, device)
    cal, ops16, ops8 = _operands(x, w, b)
    row = dict(shape=tag, B=B, C=C, T=T)
    row.update(_compare(x, ops16, ops8, cal))
    row["bf16_ms"] = _events_ms(lambda: chain.conv_chain_bf16(x, ops16), iters, on_card)
    row["i8_ms"] = _events_ms(lambda: chain.conv_chain_i8(x, ops8), iters, on_card)
    row["ratio"] = _ratio(row["bf16_ms"], row["i8_ms"])
    row["plain_bf16_ms"] = _events_ms(lambda: chain.conv_chain_bf16_plain(x, *ops16.raw), plain_iters, on_card)
    row["plain_i8_ms"] = _events_ms(lambda: chain.conv_chain_i8_plain(x, *ops8.raw), plain_iters, on_card)
    w16, b16 = chain.to_oik(w).to(torch.bfloat16).contiguous(), b.reshape(N_CONVS, C).to(torch.bfloat16)
    w32, b32 = chain.to_oik(w).contiguous(), b.reshape(N_CONVS, C)

    def cudnn_bf16():
        cur = x
        for p in range(N_CONVS):
            cur = F.leaky_relu(F.conv1d(cur, w16[p], b16[p], padding=3), chain.LRELU_SLOPE)
        return cur

    def int8_route():
        cur = x
        for p in range(N_CONVS):
            cur = F.leaky_relu(int8_ops.conv1d_w8a8(cur, w32[p], b32[p], cal["s_act"][p], padding=(3, 3)),
                               chain.LRELU_SLOPE)
        return cur

    row["library_bf16_ms"] = _events_ms(cudnn_bf16, iters, on_card)
    row["library_i8_ms"] = _events_ms(int8_route, iters, on_card)
    row.update(chain_bounds(B, C, T))
    return row


def decide(shapes) -> str:
    """The probe's rule over the decision shapes' ratios."""
    ratios = [s["ratio"] for s in shapes]
    if any(r is None for r in ratios):
        return "not taken: no device time"
    return "wire int8 towers" if all(r >= RATIO_RULE for r in ratios) else "keep bf16 towers"


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def launches_per_kernel(n_cases: int, n_shapes: int) -> int:
    """Each kernel's launches in one run on the card: a case is compared once,
    then 16 serial launches warm up and 16 are timed; a shape is compared once,
    warms up once and is timed ``SHAPE_ITERS`` times."""
    return n_cases * (1 + 2 * N_REP) + n_shapes * (2 + SHAPE_ITERS)


def run(device="cuda", tiny: bool = False, out: Optional[Callable[[dict], None]] = None) -> dict:
    """The probe: its four cases, the two decision shapes and the decision.
    ``out`` receives each row as it is measured."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    emit = out or (lambda row: None)
    result = dict(device=nvidia_smi() if on_card else "cpu", cases=[], shapes=[])
    emit({"device": result["device"]})
    with torch.no_grad(), _no_tf32():
        for C, TT in TINY_CASES if tiny else CASES:
            result["cases"].append(run_case(C, TT, device))
            emit(result["cases"][-1])
        for tag, B, C, T in TINY_SHAPES if tiny else SHAPES:
            result["shapes"].append(run_shape(tag, B, C, T, device))
            emit(result["shapes"][-1])
    result["decision"] = decide(result["shapes"])
    emit({"ratios": {s["shape"]: s["ratio"] for s in result["shapes"]}, "rule": RATIO_RULE,
          "decision": result["decision"]})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions, untimed)")
    ap.add_argument("--tiny", action="store_true", help="cases and shapes of a few hundred frames")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("int8_chain: no CUDA device is available (use --device cpu for the plain versions)")
    run(device, tiny=args.tiny, out=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
