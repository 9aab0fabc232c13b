"""HiFi-GAN resblock towers: the hand-written CUDA kernels (``csrc/resblock.cu``)
and their plain versions.

K3 ``resblock_tower`` replaces the TPU kernel
``academicodec_tpu/ops/pallas/resblock.py:_tower_kernel`` (``resblock_tower``):
the mean of G residual chains over one generator stage ``x [B, C, T]``, with
an optional lrelu -> conv_post -> tanh epilogue and an optional lrelu ->
ConvTranspose1d prologue (``pre_weight``: the stage's upsampling, computed
phase-major inside the kernel from ``x [B, C_in, T_in]``, so that the
upsampled tensor never goes to device memory). K4 ``resblock_tower_gn``
replaces ``_gn_tower_kernel`` (``resblock_tower_gn``): every chain of an
encoder stage from the same input plus the per-channel moments, then pass 2
derives the chained GroupNorm affines ``xs_g = GN_g(xs_{g-1} + r_g)`` on
``[B, C]`` scalars and applies one elementwise recombination. With
``lengths [B]`` each row is computed as if it were that long: frames past it
are read as 0 and written as 0, and the GroupNorm statistics count the valid
frames only (the JAX package's length-masked encode,
academicodec_tpu/nn/hifigan.py:318-344, which it runs on its plain lowering).
A time shard runs K4 in its passes (``parallel/sequence.py``):
:func:`gn_tower_partials` (pass 1, the per-tile partial moments kept) on
each shard, :func:`moments_reduce` over every shard's own tiles in the
sequence's tile order, :func:`gn_tower_affines` once, :func:`gn_tower_apply`
on each shard.

Chains follow the JAX call order: ResBlock1 convs ``(k, d0), (k, 1), (k, d1),
(k, 1), ...`` in pairs with a residual add per pair, ResBlock2 one conv per
add. Rounding points are the Pallas kernel's: lrelu in f32 rounded to the
storage dtype, the first conv of a pair rounded, the residual add in f32
then rounded, chain sums and means in f32.

On the H100 both are bound by operations: 0.99 TFLOP for a flagship
``[8, 64, 120000]`` stage (1.0 ms at the bf16 tensor-core peak) against
0.25-0.5 GB of traffic. The kernels keep a halo'd time window of all
channels in shared memory for the whole tower and compute only the rows
still valid after each conv. bf16 with C in {16, 32, 64} takes the
tensor-core path: a time-major swizzled window read by ``ldmatrix``, each
conv's taps streamed into shared memory by bulk copies as pre-swizzled
``[C_out][C_in]`` tiles (:func:`pack_taps`), every chain started at its own
halo (:func:`pick_tile_tc`). Everything else takes the f32 FMA path (see the
source for the designs). K4 in f32 at C in {16, 32, 64} runs
``gn_tower_fma_kernel_c``, redesigned for Hopper: a tile whose centre starts
at or past its row's length runs no conv (it writes the zeros and zero
moments; :func:`k4_tiles` counts such tiles, the counters ``k4.tiles`` and
``k4.tiles_skipped`` add them up from host lengths), a straddling tile stops
each conv at the length, each chain starts at its own halo, and two window
buffers (the first conv of a pair takes ``lrelu`` at its load) and 16 warps
with whole-strip columns a lane (:func:`pick_tile_fma_gn`) compute 1.22
columns per output column at the encoder's stage 0 against 1.88. K4's pass 2
is two more kernels, ``gn_affine_kernel`` and ``gn_apply_kernel``.

Wrappers take ``[B, C, T]`` activations and torch ``[O, I, K]`` weights, or
the operands packed once by :func:`pack_tower`. CPU tensors run the plain
version; CUDA tensors always launch the kernel or raise. The kernels have
no backward: a CUDA call that autograd would record (gradients enabled and
an input or weight requiring one) raises ``RuntimeError`` rather than return
a tensor the gradient cannot pass; ``nn/hifigan.py`` runs such stages
unfused. Each call of a wrapper adds one to the counter
``k3.launches`` or ``k4.launches`` (``utils/profiling.py``); K4's wrappers
also add their tiles to ``k4.tiles`` and ``k4.tiles_skipped`` (:func:`count_tiles`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES, check, load_library
from academicodec_tpu_torch.utils import profiling

LRELU_SLOPE = 0.1
# limits of csrc/resblock.cu: chains per tower, convs per chain, output
# channels per thread, columns per warp unit
MAX_CHAINS, MAX_CONVS, CO_TILE, STRIP = 4, 8, 8, 256
# the prologue's largest stride and taps a phase (MAX_U, MAX_PRE_TAPS)
MAX_U, MAX_PRE_TAPS = 8, 8

Weights = Sequence[Sequence[torch.Tensor]]


def chain_conv_dilations(dilations: Sequence[int], resblock: str) -> Tuple[int, ...]:
    """Dilation of each conv in one chain, in call order."""
    if resblock == "1":
        out = []
        for d in dilations:
            out.extend((d, 1))
        return tuple(out)
    return tuple(dilations)


def tower_halo(kernel_sizes: Sequence[int], dilation_sizes: Sequence[Sequence[int]],
               resblock: str = "1") -> int:
    """Per-side receptive halo of the deepest chain of the tower."""
    return max(
        sum((k - 1) // 2 * d for d in chain_conv_dilations(ds, resblock))
        for k, ds in zip(kernel_sizes, dilation_sizes)
    )


def convt_phase_taps(k: int, u: int, pad: int):
    """Tap placement of a phase-major transposed conv (the port's copy of
    academicodec_tpu/ops/conv.py:103): ``y[u q + r] = sum_m x[q - m] K[r + pad
    + u m]`` over the ``m`` with ``0 <= r + pad + u m < k``. Returns ``(m_min,
    m_max, per-phase ((m, j), ...))``."""
    phases = []
    m_lo, m_hi = 10**9, -(10**9)
    for r in range(u):
        taps = []
        for m in range(-k, k + 1):
            j = r + pad + u * m
            if 0 <= j < k:
                taps.append((m, j))
                m_lo = min(m_lo, m)
                m_hi = max(m_hi, m)
        phases.append(tuple(taps))
    return m_lo, m_hi, tuple(phases)


def frame_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """``[B, 1, T]`` bool: frame t of row b lies below ``lengths[b]``."""
    return (torch.arange(T, device=lengths.device)[None, :] < lengths.reshape(-1, 1).long())[:, None, :]


# ---------------------------------------------------------------- plain versions


def _lrelu(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.leaky_relu(v.float(), LRELU_SLOPE).to(dtype)


def _conv(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-"same" conv in f32 of storage-dtype input and weights."""
    k = w.shape[-1]
    return F.conv1d(a.float(), w.to(a.dtype).float(), b.float(), padding=(k - 1) // 2 * d, dilation=d)


def _chain(x: torch.Tensor, ws, bs, dils: Sequence[int], resblock: str, mask=None) -> torch.Tensor:
    """One chain; with ``mask [B, 1, T]`` every conv output is 0 where it is
    False, as the kernels zero outputs past a row's valid length."""
    dt = x.dtype

    def conv(a, w, b, d):
        y = _conv(a, w, b, d)
        return y if mask is None else torch.where(mask, y, 0.0)

    cur = x
    if resblock == "1":
        for p in range(0, len(dils), 2):
            y1 = conv(_lrelu(cur, dt), ws[p], bs[p], dils[p]).to(dt)
            y2 = conv(_lrelu(y1, dt), ws[p + 1], bs[p + 1], dils[p + 1])
            cur = (cur.float() + y2).to(dt)
    else:
        for p, d in enumerate(dils):
            cur = (cur.float() + conv(_lrelu(cur, dt), ws[p], bs[p], d)).to(dt)
    return cur


def _chains(x, weights, biases, dilation_sizes, resblock, mask=None) -> List[torch.Tensor]:
    if mask is not None:
        x = torch.where(mask, x, torch.zeros((), dtype=x.dtype))
    return [
        _chain(x, weights[g], biases[g], chain_conv_dilations(ds, resblock), resblock, mask)
        for g, ds in enumerate(dilation_sizes)
    ]


def convt_prologue_plain(x: torch.Tensor, pre_weight: torch.Tensor, pre_bias: Optional[torch.Tensor],
                         stride: int, pad: int) -> torch.Tensor:
    """K3's prologue: ``lrelu`` rounded to the storage dtype, then a
    ConvTranspose1d in f32 (``pre_weight [C_in, C, k]`` in the storage dtype,
    torch's crop of ``pad`` each side), rounded: ``[B, C_in, T_in] -> [B, C,
    stride T_in]``."""
    dt = x.dtype
    b = None if pre_bias is None else pre_bias.float()
    y = F.conv_transpose1d(_lrelu(x, dt).float(), pre_weight.to(dt).float(), b, stride=stride, padding=pad)
    return y.to(dt)


def resblock_tower_plain(
    x: torch.Tensor,
    weights: Weights,
    biases: Weights,
    *,
    kernel_sizes: Sequence[int],
    dilation_sizes: Sequence[Sequence[int]],
    resblock: str = "1",
    post_weight: Optional[torch.Tensor] = None,
    post_bias: Optional[torch.Tensor] = None,
    post_tanh: bool = False,
    pre_weight: Optional[torch.Tensor] = None,
    pre_bias: Optional[torch.Tensor] = None,
    pre_stride: int = 1,
    pre_pad: int = 0,
) -> torch.Tensor:
    """K3's function with ``F.conv1d`` (and ``F.conv_transpose1d`` for the
    prologue), rounding where the kernel rounds."""
    dt = x.dtype
    if pre_weight is not None:
        x = convt_prologue_plain(x, pre_weight, pre_bias, pre_stride, pre_pad)
    acc = None
    for cur in _chains(x, weights, biases, dilation_sizes, resblock):
        acc = cur.float() if acc is None else acc + cur.float()
    mean = acc / float(len(kernel_sizes))
    if post_weight is None:
        return mean.to(dt)
    if post_bias is None:
        post_bias = torch.zeros(post_weight.shape[0], device=x.device)
    y = _conv(_lrelu(mean, dt), post_weight, post_bias, 1)
    return (torch.tanh(y) if post_tanh else y).to(dt)


def moments(rs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-channel ``sum_t r_g`` then ``sum_t r_g r_h`` (order (0,0),(0,1),...,
    (1,1),...) of the chain outputs ``[B, C, T]`` -> ``[B, C, n_mom]`` f32."""
    f = [r.float() for r in rs]
    cols = [r.sum(dim=2) for r in f]
    for g in range(len(f)):
        for h in range(g, len(f)):
            cols.append((f[g] * f[h]).sum(dim=2))
    return torch.stack(cols, dim=2)


def gn_affines(
    mom: torch.Tensor,
    gn_scales: torch.Tensor,
    gn_biases: torch.Tensor,
    num_groups: int,
    epsilon: float,
    T: Union[int, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2a of K4: the chained GroupNorm affines from the moments
    ``[B, C, n_mom]`` of chain outputs of length ``T``, or of ``T[b]`` valid
    frames in row ``b`` when ``T`` is a ``[B]`` tensor of counts. With ``xs_g =
    GN_g(xs_{g-1} + r_g)`` returns ``A [G, B, C]`` and ``K [B, C]`` (f32) such
    that ``xs_last = K + sum_g A_g r_g`` (academicodec_tpu/ops/pallas/
    resblock.py:585-631, operation for operation). Plain version of
    ``gn_affine_kernel``."""
    B, C, n_mom = mom.shape
    G = gn_scales.shape[0]
    m = [mom[:, :, g] for g in range(G)]
    q = {}
    col = G
    for g in range(G):
        for h in range(g, G):
            q[(g, h)] = q[(h, g)] = mom[:, :, col]
            col += 1
    gsize = C // num_groups
    if isinstance(T, torch.Tensor):
        T = T.to(device=mom.device, dtype=torch.float32).reshape(B, 1)
        N = float(gsize) * T
    else:
        N = float(gsize * T)

    def gsum(v):  # [B, C] -> per-group sum broadcast back to [B, C]
        s = v.reshape(B, num_groups, gsize).sum(dim=2, keepdim=True)
        return s.expand(B, num_groups, gsize).reshape(B, C)

    scales = gn_scales.float()
    bn = gn_biases.float()
    zeros = torch.zeros((B, C), dtype=torch.float32, device=mom.device)
    A = [zeros for _ in range(G)]
    K = zeros
    for g in range(G):
        A[g] = A[g] + 1.0
        S = K * T
        for h in range(G):
            S = S + A[h] * m[h]
        Q = K * K * T
        for h in range(G):
            Q = Q + 2.0 * K * A[h] * m[h]
            for l in range(G):
                Q = Q + A[h] * A[l] * q[(h, l)]
        mu = gsum(S) / N
        var = gsum(Q) / N - mu * mu
        a = scales[g] * torch.rsqrt(var + epsilon)
        b = bn[g] - mu * a
        A = [a * Ah for Ah in A]
        K = a * K + b
    return torch.stack(A), K


def gn_apply(rs: Sequence[torch.Tensor], A: torch.Tensor, K: torch.Tensor,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass 2b of K4: ``out = K / G + sum_g (A_g / G) r_g`` in f32, rounded once
    to the storage dtype; with ``lengths [B]``, 0 past each row's length.
    Plain version of ``gn_apply_kernel``."""
    G = len(rs)
    inv = 1.0 / float(G)
    out = K[:, :, None] * inv
    for g in range(G):
        out = out + (A[g] * inv)[:, :, None] * rs[g].float()
    if lengths is not None:
        out = torch.where(frame_mask(lengths, out.shape[2]), out, 0.0)
    return out.to(rs[0].dtype)


def gn_recombine(
    rs: Sequence[torch.Tensor],
    mom: torch.Tensor,
    gn_scales: torch.Tensor,
    gn_biases: torch.Tensor,
    num_groups: int,
    epsilon: float,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pass 2 of K4: :func:`gn_affines` then :func:`gn_apply`."""
    T = rs[0].shape[2] if lengths is None else lengths
    A, K = gn_affines(mom, gn_scales, gn_biases, num_groups, epsilon, T)
    return gn_apply(rs, A, K, lengths)


def clamp_lengths(lengths, B: int, T: int, device) -> torch.Tensor:
    """``lengths`` (any integer sequence or tensor of ``B`` entries) as a
    contiguous int32 tensor on ``device``, clamped to ``[0, T]`` as the
    kernels clamp them. Host lengths reach a card by an asynchronous copy from
    pinned memory: the host does not wait for the device."""
    L = torch.as_tensor(lengths).reshape(-1)
    if L.numel() != B or L.is_floating_point():
        raise ValueError(f"lengths: {B} integer lengths expected, got {tuple(L.shape)} {L.dtype}")
    L = L.clamp(0, T).to(torch.int32).contiguous()
    device = torch.device(device)
    if L.device.type == "cpu" and device.type == "cuda":
        return L.pin_memory().to(device, non_blocking=True)
    return L.to(device)


def on_host(lengths) -> bool:
    """Whether ``lengths`` can be read without waiting for a device: a sequence or a CPU tensor."""
    return not (isinstance(lengths, torch.Tensor) and lengths.device.type != "cpu")


def k4_tiles(lengths, B: int, T: int, TT: int) -> Tuple[int, int]:
    """``(tiles, tiles past the length)`` of one K4 pass-1 launch over ``[B, C, T]``
    in tiles of ``TT`` steps: row ``b``'s tiles from ``ceil(lengths[b] / TT)`` on
    (``lengths[b]`` clamped to ``[0, T]``) start at or past its valid length.
    ``lengths``: host integers, or None (no tile past it)."""
    nT = -(-T // TT)
    if lengths is None:
        return B * nT, 0
    L = torch.as_tensor(lengths).reshape(-1).long().clamp(0, T)
    return B * nT, int((nT - (L + TT - 1) // TT).sum())


def count_tiles(lengths, B: int, T: int, TT: int, skips: bool) -> None:
    """Add one K4 pass-1 launch's blocks to the counters ``k4.tiles`` and, where
    the kernel skips them (``skips``: ``gn_tower_fma_kernel_c``),
    ``k4.tiles_skipped``: the tiles that start at or past their row's length and
    run no conv. From ``lengths`` as the caller holds them; lengths on a card
    count nothing (reading them would wait for the device)."""
    if not on_host(lengths):
        return
    tiles, past = k4_tiles(lengths, B, T, TT)
    profiling.count("k4.tiles", tiles)
    profiling.count("k4.tiles_skipped", past if skips else 0)


def resblock_tower_gn_plain(
    x: torch.Tensor,
    weights: Weights,
    biases: Weights,
    gn_scales: torch.Tensor,
    gn_biases: torch.Tensor,
    *,
    kernel_sizes: Sequence[int],
    dilation_sizes: Sequence[Sequence[int]],
    resblock: str = "1",
    num_groups: int,
    epsilon: float = 1e-6,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4's function: the chains with ``F.conv1d``, moments of the rounded
    chain outputs, then :func:`gn_recombine`; with ``lengths [B]`` every row
    computed at its own length (frames past it 0)."""
    mask = None
    if lengths is not None:
        lengths = clamp_lengths(lengths, x.shape[0], x.shape[2], x.device)
        mask = frame_mask(lengths, x.shape[2])
    rs = _chains(x, weights, biases, dilation_sizes, resblock, mask)
    return gn_recombine(rs, moments(rs), gn_scales, gn_biases, num_groups, epsilon, lengths)


# ---------------------------------------------------------------- kernel wrappers

# the tensor-core path of csrc/resblock.cu: channel counts it takes, ring
# stages, rows a window buffer holds past the window, consumer warps, and the
# most window rows by C: 8 warps x 16-row m-tiles x 4 a warp, 3 at C 64, where
# a fourth would push a tap's fragments out of the registers
TC_CHANNELS, TC_STAGES, TC_PAD_ROWS, TC_WARPS = (16, 32, 64), 4, 16, 8
TC_MAX_ROWS = {16: 512, 32: 384, 64: 384}
# shared memory a block may take: all of an SM's at C 64, half of it (two
# resident blocks, 1 KB each reserved by the system) below
TC_SMEM_BUDGET = {16: 113 * 1024, 32: 113 * 1024, 64: MAX_SMEM_BYTES}


def uses_tc(dtype: torch.dtype, C: int) -> bool:
    """Whether the kernel's convs run on the bf16 tensor cores (else f32 FMAs)."""
    return dtype == torch.bfloat16 and C in TC_CHANNELS


def row_stride(width: int) -> int:
    """Shared-memory row stride of the FMA path's window (``row_stride`` in csrc/resblock.cu)."""
    return -(-width // 8) * 8


# K4's f32 FMA path at these channel counts (gn_tower_fma_kernel_c): 16 warps, a
# lane's columns in one conv from FMA_GN_NT[0] to FMA_GN_NT[1]
FMA_GN_CHANNELS, FMA_GN_WARPS, FMA_GN_NT = (16, 32, 64), 16, (4, 8)


def uses_fma_gn(dtype: torch.dtype, C: int) -> bool:
    """Whether K4's pass 1 runs ``gn_tower_fma_kernel_c`` (f32 at C 16, 32, 64)."""
    return dtype == torch.float32 and C in FMA_GN_CHANNELS


def fma_gn_span(C: int) -> int:
    """Columns a conv of ``gn_tower_fma_kernel_c`` computes for each column a lane
    holds: 32 lanes x the warps side by side along time (``gn_span``)."""
    return 32 * FMA_GN_WARPS // (C // CO_TILE)


def fma_gn_smem(C: int, W: int) -> int:
    """Shared bytes of ``gn_tower_fma_kernel_c`` at a window of ``W`` columns
    (``gn_fma_smem``): two f32 ``[C][row_stride(W)]`` buffers and one span."""
    return (2 * C * row_stride(W) + fma_gn_span(C)) * 4


@dataclass(frozen=True)
class FmaGnGeometry:
    """One block of ``gn_tower_fma_kernel_c``: ``TT`` output columns from a window
    of ``W = TT + 2H``; ``smem`` bytes of dynamic shared memory; ``nts`` each
    conv's columns a lane (call order, chain after chain, every chain at its
    own halo); ``cost`` columns computed per output column, tap-weighted."""

    TT: int
    W: int
    H: int
    smem: int
    nts: Tuple[int, ...]
    cost: float


@functools.lru_cache(maxsize=None)
def pick_tile_fma_gn(C: int, kernel_sizes: Tuple[int, ...], dilation_sizes: Tuple[Tuple[int, ...], ...],
                     resblock: str) -> FmaGnGeometry:
    """K4's f32 FMA path at C in :data:`FMA_GN_CHANNELS`: the ``TT`` (a multiple of
    8, at least 16) whose window fits shared memory and computes the fewest
    columns per output column. A conv whose range is ``n`` columns computes
    ``fma_gn_span(C) * NT`` of them, ``NT = ceil(n / span)`` at least
    ``FMA_GN_NT[0]``; the window is at most ``FMA_GN_NT[1]`` spans, and TT at
    least ``FMA_GN_NT[0] - 1`` spans, so that a conv's reads (from a column at
    most H, a halo at most H) stay within a row and one span."""
    halos = chain_halos(kernel_sizes, dilation_sizes, resblock)
    H, span = max(halos), fma_gn_span(C)
    taps = sum(k * len(chain_conv_dilations(ds, resblock)) for k, ds in zip(kernel_sizes, dilation_sizes))
    best = None
    tt = max(16, -(-(FMA_GN_NT[0] - 1) * span // 8) * 8)
    while fma_gn_smem(C, tt + 2 * H) <= MAX_SMEM_BYTES and tt + 2 * H <= FMA_GN_NT[1] * span:
        W, nts, cols = tt + 2 * H, [], 0
        for k, ds, h in zip(kernel_sizes, dilation_sizes, halos):
            lo, hi = H - h, W - (H - h)
            for d in chain_conv_dilations(ds, resblock):
                lo, hi = lo + (k - 1) // 2 * d, hi - (k - 1) // 2 * d
                nts.append(max(FMA_GN_NT[0], -(-(hi - lo) // span)))
                cols += k * nts[-1] * span
        cost = cols / (tt * taps)
        if best is None or cost <= best.cost:
            best = FmaGnGeometry(tt, W, H, fma_gn_smem(C, W), tuple(nts), cost)
        tt += 8
    if best is None:
        raise ValueError(f"resblock tower: C={C} with halo {H} does not fit K4's f32 window")
    return best


def pick_tile(C: int, H: int, post_halo: int, itemsize: int, with_acc: bool, u: int = 1) -> Tuple[int, int]:
    """FMA path: ``(TT, shared bytes)``, output columns per block. The window
    ``TT + 2H`` is ``64 // C`` 256-column strips where they fit (8 warps x 8
    channels busy), else the widest multiple of 8 columns that fits shared
    memory (at least 16 output columns). With K3's prologue of stride ``u``,
    ``TT`` is a multiple of ``u`` (``H`` is already)."""
    least = 2 * H + 16
    top = max(-(-least // STRIP), 64 // C) * STRIP
    for width in range(top, least - 1, -8):
        tt = width - 2 * H
        if tt % u:
            continue
        smem = 3 * C * row_stride(width) * itemsize
        if with_acc:
            smem += C * (tt + 2 * post_halo) * 4
        if smem <= MAX_SMEM_BYTES:
            return tt, smem
    raise ValueError(f"resblock tower: C={C} with halo {H} does not fit in shared memory")


@dataclass(frozen=True)
class TileGeometry:
    """One block of the tensor-core path: ``TT`` output columns from a window
    of ``W = TT + 2H`` rows, chain ``g`` starting at window row ``starts[g]``;
    ``buf`` bytes per window buffer, ``smem`` bytes of dynamic shared memory,
    ``cost`` rows multiplied per useful row (tap-weighted, in whole m-tile
    rounds of 8 warps)."""

    TT: int
    W: int
    H: int
    starts: Tuple[int, ...]
    buf: int
    smem: int
    blocks_per_sm: int
    cost: float


def chain_halos(kernel_sizes, dilation_sizes, resblock: str) -> Tuple[int, ...]:
    return tuple(
        sum((k - 1) // 2 * d for d in chain_conv_dilations(ds, resblock))
        for k, ds in zip(kernel_sizes, dilation_sizes)
    )


@dataclass(frozen=True)
class PreGeometry:
    """K3's prologue as the tile geometry sees it: stride ``u``, ``n_half =
    C_in / C`` input-channel slices on the tensor-core path, ``span = m_max -
    m_min`` extra input rows, ``tiles`` = the ring tiles of one chain's
    prologue (sum over phases of taps x slices)."""

    u: int
    n_half: int
    span: int
    tiles: int


def pre_slice_bytes(C: int, nq: int, span: int) -> int:
    """Bytes of one ``C``-channel slice of K3's prologue input window in shared
    memory: ``ceil(nq / 16) * 16 + span`` rows of ``2C`` bytes (ragged m-tiles
    read 16-row tiles), rounded up to 1024 (tower_kernel's ``zh``)."""
    return -(-((-(-nq // 16) * 16 + span) * 2 * C) // 1024) * 1024


@functools.lru_cache(maxsize=None)
def pick_tile_tc(C: int, kernel_sizes: Tuple[int, ...], dilation_sizes: Tuple[Tuple[int, ...], ...],
                 resblock: str, post_halo: int, gn: bool, pre: Optional[PreGeometry] = None) -> TileGeometry:
    """Tensor-core path: the ``TT`` (a multiple of 8, at least 16) whose window
    fits its shared-memory budget and row cap and costs the fewest multiplied
    rows per output column. A conv over ``R`` rows costs ``k * ceil(ceil(R / 16) / 8)``
    rounds of 8 warps x 16 rows; chain ``g`` starts at its own halo, ``Hc -
    Hc_g`` rows into the window. Shared memory: 1024 bytes of alignment slack,
    the ring, three ``(W + 16)``-row windows, K3's f32 chain sum (row stride
    ``C + 1``) or K4's ``G - 1`` centre tiles, the mbarriers. With K3's
    prologue (``pre``): ``TT`` is a multiple of ``u`` (``H`` is already), each
    phase's ``W / u`` rows are at most 256 (two m-tiles a warp), the input
    window's ``n_half`` slices fit in one window buffer, and each chain adds
    its prologue's tiles at ``W / u`` rows to the cost."""
    rb = 2 * C
    halos = chain_halos(kernel_sizes, dilation_sizes, resblock)
    Hc, G = max(halos), len(kernel_sizes)
    H = Hc + post_halo
    n_mom = G + G * (G + 1) // 2
    step = 8 if pre is None else 8 * pre.u // math.gcd(8, pre.u)
    best = None
    for tt in range(-(-16 // step) * step, TC_MAX_ROWS[C] - 2 * H + 1, step):
        W = tt + 2 * H
        buf = -(-(W + TC_PAD_ROWS) * rb // 1024) * 1024
        pre_rounds = 0
        if pre is not None:
            nq = W // pre.u
            if nq > 256:
                continue
            buf = max(buf, pre.n_half * pre_slice_bytes(C, nq, pre.span))
            m_tiles = -(-nq // 16)
            pre_rounds = G * pre.tiles * -(-m_tiles // TC_WARPS)
        if gn:
            buf = max(buf, 1024 * n_mom)  # 2 buf >= the moments' scratch, 2048 n_mom bytes
            extra = (G - 1) * tt * rb  # the last chain's centre tile stays in a free window
        else:
            extra = (tt + 2 * post_halo) * (C + 1) * 4
        smem = 1024 + TC_STAGES * C * rb + 3 * buf + -(-extra // 16) * 16 + 16 * TC_STAGES
        if smem > TC_SMEM_BUDGET[C]:
            continue
        rounds = pre_rounds
        for k, ds, h in zip(kernel_sizes, dilation_sizes, halos):
            lo = Hc - h
            hi = W - lo
            for d in chain_conv_dilations(ds, resblock):
                lo += (k - 1) // 2 * d
                hi -= (k - 1) // 2 * d
                m_tiles = -(-(hi - lo) // 16)
                rounds += k * -(-m_tiles // TC_WARPS)
        taps = sum(k * len(chain_conv_dilations(ds, resblock)) for k, ds in zip(kernel_sizes, dilation_sizes))
        cost = rounds * 16 * TC_WARPS / (tt * taps)
        if best is None or cost <= best.cost:
            best = TileGeometry(tt, W, H, tuple(Hc - h for h in halos), buf, smem,
                                1 if C == 64 else 2, cost)
    if best is None:
        raise ValueError(f"resblock tower: C={C} with halo {H} does not fit {TC_MAX_ROWS[C]} rows of shared memory")
    return best


def swizzle_perm(C: int) -> torch.Tensor:
    """Element permutation of a row-major ``[C][C]`` bf16 tile under the
    kernel's swizzle: 16-byte chunks (8 elements) XORed with the 128-byte line
    index. An involution: ``tile.flatten()[perm]`` swizzles and unswizzles."""
    e = torch.arange(C * C)
    return e ^ (((e >> 6) & (C // 8 - 1)) << 3)


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """``[O, I, K]`` -> ``K`` swizzled ``[O][I]`` tap tiles, flat, tap after tap."""
    O, I, K = w.shape
    return w.permute(2, 0, 1).reshape(K, O * I)[:, swizzle_perm(O).to(w.device)].reshape(-1)


def unpack_taps(flat: torch.Tensor, C: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_taps`: ``[C, C, k]``."""
    return flat.reshape(k, C * C)[:, swizzle_perm(C).to(flat.device)].reshape(k, C, C).permute(1, 2, 0)


@dataclass
class PackedTower:
    """A tower's operands as the wrappers take them: the weights ``[O, I, K]``
    and biases as given (what the plain versions read) and, for CUDA tensors,
    the kernel's operands: every conv's weights in ``dtype`` (tap tiles for the
    tensor-core path, ``[C_in][k][C_out]`` for the FMA path), chain after chain
    in call order, the biases f32, the C ``spec`` array, the post conv's
    operands, the prologue's (on the tensor-core path its tiles lead each
    chain's taps in ``w_all``; on the FMA path ``wpre [k][C][C_in]``). Build
    with :func:`pack_tower`."""

    weights: Weights
    biases: Weights
    kernel_sizes: Tuple[int, ...]
    dilation_sizes: Tuple[Tuple[int, ...], ...]
    resblock: str
    post_weight: Optional[torch.Tensor]
    post_bias: Optional[torch.Tensor]
    dtype: torch.dtype
    device: torch.device
    C: int
    pre_weight: Optional[torch.Tensor] = None
    pre_bias: Optional[torch.Tensor] = None
    pre_stride: int = 1
    pre_pad: int = 0
    tc: bool = False
    w_all: Optional[torch.Tensor] = None
    b_all: Optional[torch.Tensor] = None
    spec: Any = None
    wp: Optional[torch.Tensor] = None
    bp: Optional[torch.Tensor] = None
    wpre: Optional[torch.Tensor] = None
    bpre: Optional[torch.Tensor] = None
    pre_geo: Optional[PreGeometry] = None

    @property
    def C_in(self) -> int:
        """Channels of the tower's input: the prologue's, or C."""
        return self.C if self.pre_weight is None else self.pre_weight.shape[0]


def _pre_spec(pre_weight: torch.Tensor, C: int, u: int, pad: int):
    """Validate K3's prologue; returns its phase taps and m_max, m_min."""
    if pre_weight.dim() != 3 or pre_weight.shape[1] != C:
        raise ValueError(f"resblock tower: pre weight {tuple(pre_weight.shape)} for C={C} ([C_in, C, k])")
    k = pre_weight.shape[2]
    if not (1 <= u <= MAX_U) or 2 * pad != k - u:
        raise ValueError(f"resblock tower: the prologue takes stride 1..{MAX_U} and pad (k - stride) / 2; "
                         f"got k={k}, stride {u}, pad {pad}")
    m_lo, m_hi, phases = convt_phase_taps(k, u, pad)
    if max(len(t) for t in phases) > MAX_PRE_TAPS:
        raise ValueError(f"resblock tower: k={k}, stride {u}: more than {MAX_PRE_TAPS} taps a phase")
    return phases, m_hi, m_lo


def pack_tower(
    weights: Weights,
    biases: Weights,
    *,
    kernel_sizes: Sequence[int],
    dilation_sizes: Sequence[Sequence[int]],
    resblock: str = "1",
    post_weight: Optional[torch.Tensor] = None,
    post_bias: Optional[torch.Tensor] = None,
    pre_weight: Optional[torch.Tensor] = None,
    pre_bias: Optional[torch.Tensor] = None,
    pre_stride: int = 1,
    pre_pad: int = 0,
    dtype: Optional[torch.dtype] = None,
) -> PackedTower:
    """Validate a tower's operands and, when they lie on a card, pack them
    for the kernels in ``dtype`` (default: the weights' own). The result can
    be passed to :func:`resblock_tower` / :func:`resblock_tower_gn` in place of
    the raw weights any number of times. ``pre_weight [C_in, C, k]`` (torch
    ConvTranspose1d layout), ``pre_bias [C]``, ``pre_stride`` and ``pre_pad``
    (``(k - stride) / 2``) give K3's prologue."""
    kernel_sizes = tuple(kernel_sizes)
    dilation_sizes = tuple(tuple(ds) for ds in dilation_sizes)
    G = len(kernel_sizes)
    if not (1 <= G <= MAX_CHAINS) or len(dilation_sizes) != G or len(weights) != G or len(biases) != G:
        raise ValueError(f"resblock tower: {G} chains (the kernel takes 1..{MAX_CHAINS})")
    if resblock not in ("1", "2"):
        raise ValueError(f"resblock tower: resblock {resblock!r}")
    first = weights[0][0]
    C, dev = first.shape[0], first.device
    dtype = dtype or first.dtype
    packed = PackedTower(weights, biases, kernel_sizes, dilation_sizes, resblock, post_weight, post_bias,
                         dtype, dev, C, pre_weight, pre_bias, pre_stride, pre_pad)
    if pre_weight is not None:
        phases, m_hi, m_lo = _pre_spec(pre_weight, C, pre_stride, pre_pad)
    tensors = [*(t for ch in weights for t in ch), *(t for ch in biases for t in ch)]
    tensors += [t for t in (post_weight, post_bias, pre_weight, pre_bias) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError("resblock tower: weights and biases on different devices")
    if dev.type == "cpu":
        return packed
    if dev.type != "cuda":
        raise ValueError(f"resblock tower: weights on {dev}; the kernel takes CUDA tensors")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resblock tower: no kernel for {dtype}")
    if C % CO_TILE or C == 0:
        raise ValueError(f"resblock tower: C={C} must be a positive multiple of {CO_TILE}")
    # the tensor-core prologue reads its input in C-channel slices
    packed.tc = uses_tc(dtype, C) and (pre_weight is None or packed.C_in % C == 0)
    n_spec = 3 + 2 * MAX_CHAINS + MAX_CHAINS * MAX_CONVS
    spec = [0] * (n_spec + 4 + MAX_U + 2 * MAX_U * MAX_PRE_TAPS)
    spec[0], spec[1], spec[2] = int(packed.tc), G, int(resblock)
    pre_tiles = []
    if pre_weight is not None:
        C_in, u = packed.C_in, pre_stride
        spec[n_spec:n_spec + 4] = [u, C_in, m_hi, m_hi - m_lo]
        w = pre_weight.detach().to(dtype)
        for r, taps in enumerate(phases):
            spec[n_spec + 4 + r] = len(taps)
            for e, (m, j) in enumerate(taps):
                spec[n_spec + 4 + MAX_U + r * MAX_PRE_TAPS + e] = m
                spec[n_spec + 4 + MAX_U + MAX_U * MAX_PRE_TAPS + r * MAX_PRE_TAPS + e] = j
                if packed.tc:  # one [C_out][C] tile per input-channel slice h: W[h C + ci, co, j]
                    pre_tiles += [pack_taps(w[h * C:(h + 1) * C, :, j].t()[:, :, None]) for h in range(C_in // C)]
        if packed.tc:
            packed.pre_geo = PreGeometry(u, C_in // C, m_hi - m_lo, len(pre_tiles))
        else:
            packed.wpre = w.permute(2, 1, 0).contiguous()  # [k][C][C_in]
        bpre = pre_bias if pre_bias is not None else torch.zeros(C, device=dev)
        if tuple(bpre.shape) != (C,):
            raise ValueError(f"resblock_tower: pre bias {tuple(bpre.shape)}")
        packed.bpre = bpre.detach().float().contiguous()
    ws, bs = [], []
    for g, (k, ds) in enumerate(zip(kernel_sizes, dilation_sizes)):
        dils = chain_conv_dilations(ds, resblock)
        if k % 2 == 0 or len(dils) > MAX_CONVS or len(weights[g]) != len(dils) or len(biases[g]) != len(dils):
            raise ValueError(f"resblock tower: chain {g}: k={k}, {len(dils)} convs, {len(weights[g])} weights")
        spec[3 + g], spec[3 + MAX_CHAINS + g] = k, len(dils)
        ws += pre_tiles  # the tap stream: each chain recomputes its window through the prologue
        for i, d in enumerate(dils):
            spec[3 + 2 * MAX_CHAINS + g * MAX_CONVS + i] = d
            w, b = weights[g][i], biases[g][i]
            if tuple(w.shape) != (C, C, k) or tuple(b.shape) != (C,):
                raise ValueError(f"resblock tower: chain {g} conv {i}: weight {tuple(w.shape)}")
            w = w.detach().to(dtype)
            ws.append(pack_taps(w) if packed.tc else w.permute(1, 2, 0).reshape(-1))
            bs.append(b.detach().float().reshape(-1))
    packed.w_all, packed.b_all = torch.cat(ws).contiguous(), torch.cat(bs).contiguous()
    packed.spec = (ctypes.c_int * len(spec))(*spec)
    if post_weight is not None:
        c_out, c_in, kp = post_weight.shape
        if c_in != C or kp % 2 == 0:
            raise ValueError(f"resblock_tower: post weight {tuple(post_weight.shape)} for C={C}")
        packed.wp = post_weight.detach().to(dtype).contiguous()
        bp = post_bias if post_bias is not None else torch.zeros(c_out, device=dev)
        if tuple(bp.shape) != (c_out,):
            raise ValueError(f"resblock_tower: post bias {tuple(bp.shape)}")
        packed.bp = bp.detach().float().contiguous()
    return packed


def _as_packed(x, weights, biases, kernel_sizes, dilation_sizes, resblock, **extra) -> PackedTower:
    if isinstance(weights, PackedTower):
        return weights
    return pack_tower(weights, biases, kernel_sizes=kernel_sizes, dilation_sizes=dilation_sizes,
                      resblock=resblock, dtype=x.dtype, **extra)


def _check_call(x: torch.Tensor, packed: PackedTower, name: str) -> None:
    """A CUDA call launches or raises: ``x`` must be a contiguous ``[B, C_in, T]``
    tensor on the card and in the dtype the operands were packed for."""
    if x.device.type != "cuda" or packed.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, weights on {packed.device}; the kernel takes CUDA tensors")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, C, T] tensor")
    if x.dtype != packed.dtype or x.shape[1] != packed.C_in:
        raise ValueError(f"{name}: x {x.dtype} [., {x.shape[1]}, .] for operands packed as "
                         f"{packed.dtype} with C_in={packed.C_in}")


def _check_no_grad(name: str, packed: PackedTower, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd would record a kernel call (the kernels have no backward)."""
    if not torch.is_grad_enabled():
        return
    ops = [*tensors, *(t for ch in packed.weights for t in ch), *(t for ch in packed.biases for t in ch),
           packed.post_weight, packed.post_bias, packed.pre_weight, packed.pre_bias]
    if any(t is not None and t.requires_grad for t in ops):
        raise RuntimeError(f"{name}: the kernel has no backward, and autograd would record this call; run "
                           "the stage's unfused modules under autograd, or call it under torch.no_grad()")


def tower_geometry(packed: PackedTower, gn: bool):
    """``(TT, H, Hc, buf, smem)`` of a launch; ``buf`` and ``smem`` are 0 on the
    FMA path, which sizes its own shared memory. ``H`` is the deepest chain's
    halo plus the post conv's, rounded up to a multiple of the prologue's
    stride, so that every tile's window starts on a phase boundary (JAX rounds
    its halo likewise, academicodec_tpu/ops/pallas/resblock.py:394-401)."""
    Hc = tower_halo(packed.kernel_sizes, packed.dilation_sizes, packed.resblock)
    P = 0 if packed.wp is None else (packed.wp.shape[2] - 1) // 2
    u = 1 if packed.pre_weight is None else packed.pre_stride
    H = -(-(Hc + P) // u) * u
    if packed.tc:
        geo = pick_tile_tc(packed.C, packed.kernel_sizes, packed.dilation_sizes, packed.resblock, H - Hc, gn,
                           packed.pre_geo)
        return geo.TT, H, Hc, geo.buf, geo.smem
    if gn and uses_fma_gn(packed.dtype, packed.C):
        return pick_tile_fma_gn(packed.C, packed.kernel_sizes, packed.dilation_sizes, packed.resblock).TT, H, Hc, 0, 0
    itemsize = 2 if packed.dtype == torch.bfloat16 else 4
    TT, _ = pick_tile(packed.C, H, H - Hc, itemsize, with_acc=not gn, u=u)
    return TT, H, Hc, 0, 0


def resblock_tower(
    x: torch.Tensor,
    weights: Union[Weights, PackedTower],
    biases: Optional[Weights] = None,
    *,
    kernel_sizes: Optional[Sequence[int]] = None,
    dilation_sizes: Optional[Sequence[Sequence[int]]] = None,
    resblock: str = "1",
    post_weight: Optional[torch.Tensor] = None,
    post_bias: Optional[torch.Tensor] = None,
    post_tanh: bool = False,
    pre_weight: Optional[torch.Tensor] = None,
    pre_bias: Optional[torch.Tensor] = None,
    pre_stride: int = 1,
    pre_pad: int = 0,
) -> torch.Tensor:
    """Mean of the resblock chains over ``x [B, C, T]`` -> ``[B, C, T]``, or
    with ``post_weight [C_post, C, kp]``: ``(tanh)(conv(lrelu(mean)))`` ->
    ``[B, C_post, T]``. ``weights[g][i]`` is conv ``i`` of chain ``g``,
    ``[C, C, k]``; ``biases[g][i]`` is ``[C]``. With ``pre_weight [C_in, C, k]``
    the tower's input is ``ConvTranspose1d(lrelu(x))`` of ``x [B, C_in, T_in]``
    (stride ``pre_stride``, crop ``pre_pad = (k - stride) / 2`` a side, so
    ``T = stride T_in``). ``weights`` may instead be a :class:`PackedTower`
    (then it carries the biases, the chain structure, the post conv and the
    prologue)."""
    p = _as_packed(x, weights, biases, kernel_sizes, dilation_sizes, resblock,
                   post_weight=post_weight, post_bias=post_bias, pre_weight=pre_weight, pre_bias=pre_bias,
                   pre_stride=pre_stride, pre_pad=pre_pad)
    if x.device.type == "cpu" and p.device.type == "cpu":
        return resblock_tower_plain(
            x, p.weights, p.biases, kernel_sizes=p.kernel_sizes, dilation_sizes=p.dilation_sizes,
            resblock=p.resblock, post_weight=p.post_weight, post_bias=p.post_bias, post_tanh=post_tanh,
            pre_weight=p.pre_weight, pre_bias=p.pre_bias, pre_stride=p.pre_stride, pre_pad=p.pre_pad,
        )
    _check_call(x, p, "resblock_tower")
    _check_no_grad("resblock_tower", p, x)
    B, C, T_in = x.shape[0], p.C, x.shape[2]
    T = T_in if p.pre_weight is None else T_in * p.pre_stride
    c_out, kp = (C, 1) if p.wp is None else (p.wp.shape[0], p.wp.shape[2])
    TT, H, Hc, buf, smem = tower_geometry(p, gn=False)
    y = torch.empty((B, c_out, T), dtype=x.dtype, device=x.device)
    if B == 0 or T == 0:
        return y

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = load_library().acad_resblock_tower(
        x.data_ptr(), p.w_all.data_ptr(), p.b_all.data_ptr(), ptr(p.wp), ptr(p.bp), ptr(p.wpre), ptr(p.bpre),
        y.data_ptr(), p.spec, B, C, T, T_in, TT, H, Hc, buf, smem, c_out, kp, int(post_tanh),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "resblock_tower")
    profiling.count("k3.launches")
    return y


def gn_tower_chains(x: torch.Tensor, p: PackedTower, lengths=None,
                    partials: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of K4 on the card: the chain outputs ``[G, B, C, T]`` and their
    moments ``[B, C, n_mom]`` (per-tile partials summed in tile order), or with
    ``partials`` the per-tile partials ``[B, nT, C, n_mom]`` themselves (the
    reduction is then not launched); with ``lengths [B]`` each row at its own
    length. Counts one launch."""
    _check_call(x, p, "resblock_tower_gn")
    if p.pre_weight is not None:
        raise ValueError("resblock_tower_gn: K4 has no prologue")
    B, C, T = x.shape
    G = len(p.kernel_sizes)
    TT, H, _, buf, smem = tower_geometry(p, gn=True)
    n_mom = G + G * (G + 1) // 2
    nT = -(-T // TT)
    L = None if lengths is None else clamp_lengths(lengths, B, T, x.device)
    outs = torch.empty((G, B, C, T), dtype=x.dtype, device=x.device)
    part = torch.empty((B, nT, C, n_mom), dtype=torch.float32, device=x.device)
    mom = None if partials else torch.empty((B, C, n_mom), dtype=torch.float32, device=x.device)
    rc = load_library().acad_resblock_tower_gn(
        x.data_ptr(), p.w_all.data_ptr(), p.b_all.data_ptr(), outs.data_ptr(), part.data_ptr(),
        None if mom is None else mom.data_ptr(), None if L is None else L.data_ptr(), p.spec, B, C, T, TT, H,
        buf, smem, int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "resblock_tower_gn")
    profiling.count("k4.launches")
    return outs, (part if partials else mom)


def gn_affines_cuda(mom, gn_scales, gn_biases, num_groups: int, epsilon: float, T: int, lengths=None):
    """``gn_affine_kernel``: :func:`gn_affines` on the card, one block per batch
    row; with ``lengths [B]`` (clamped to ``[0, T]``) each row's statistics
    count its valid frames."""
    B, C, _ = mom.shape
    G = gn_scales.shape[0]
    if mom.device.type != "cuda" or mom.dtype != torch.float32 or not mom.is_contiguous():
        raise ValueError("gn_affines_cuda: mom must be a contiguous f32 CUDA tensor")
    scales, bn = gn_scales.float().contiguous(), gn_biases.float().contiguous()
    L = None if lengths is None else clamp_lengths(lengths, B, T, mom.device)
    A = torch.empty((G, B, C), dtype=torch.float32, device=mom.device)
    K = torch.empty((B, C), dtype=torch.float32, device=mom.device)
    rc = load_library().acad_gn_affine(
        mom.data_ptr(), scales.data_ptr(), bn.data_ptr(), None if L is None else L.data_ptr(), A.data_ptr(),
        K.data_ptr(), B, C, G, num_groups, T, float(epsilon), torch.cuda.current_stream(mom.device).cuda_stream,
    )
    check(rc, "gn_affine")
    return A, K


def gn_apply_cuda(rs: torch.Tensor, A: torch.Tensor, K: torch.Tensor, lengths=None) -> torch.Tensor:
    """``gn_apply_kernel``: :func:`gn_apply` on the card, ``rs [G, B, C, T]`` in
    one pass; with ``lengths [B]``, 0 past each row's length."""
    G, B, C, T = rs.shape
    if rs.device.type != "cuda" or not rs.is_contiguous() or rs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("gn_apply_cuda: rs must be a contiguous f32 or bf16 CUDA tensor")
    if tuple(A.shape) != (G, B, C) or tuple(K.shape) != (B, C) or A.dtype != torch.float32 or K.dtype != torch.float32:
        raise ValueError(f"gn_apply_cuda: A {tuple(A.shape)}, K {tuple(K.shape)} for rs {tuple(rs.shape)}")
    L = None if lengths is None else clamp_lengths(lengths, B, T, rs.device)
    y = torch.empty((B, C, T), dtype=rs.dtype, device=rs.device)
    rc = load_library().acad_gn_apply(
        rs.data_ptr(), A.contiguous().data_ptr(), K.contiguous().data_ptr(), None if L is None else L.data_ptr(),
        y.data_ptr(), B, C, T, G, int(rs.dtype == torch.bfloat16), torch.cuda.current_stream(rs.device).cuda_stream,
    )
    check(rc, "gn_apply")
    return y


def resblock_tower_gn(
    x: torch.Tensor,
    weights: Union[Weights, PackedTower],
    biases: Optional[Weights],
    gn_scales: torch.Tensor,
    gn_biases: torch.Tensor,
    *,
    kernel_sizes: Optional[Sequence[int]] = None,
    dilation_sizes: Optional[Sequence[Sequence[int]]] = None,
    resblock: str = "1",
    num_groups: int,
    epsilon: float = 1e-6,
    lengths=None,
) -> torch.Tensor:
    """Encoder resblock bundle over ``x [B, C, T]`` (reference
    models.py:405-416): ``xs_0 = GN_0(r_0)``, ``xs_g = GN_g(xs_{g-1} + r_g)``,
    ``out = xs_last / G``, every chain ``r_g`` reading ``x``.
    ``gn_scales``/``gn_biases`` are ``[G, C]``. ``weights`` may be a
    :class:`PackedTower` (``biases`` is then not read). With ``lengths [B]``
    (integers, clamped to ``[0, T]``) row ``b`` is computed as if it were
    ``lengths[b]`` frames long and is 0 past them: the JAX package's masked
    encode stage (academicodec_tpu/nn/hifigan.py:318-344, 456-468)."""
    p = _as_packed(x, weights, biases, kernel_sizes, dilation_sizes, resblock)
    if all(t.device.type == "cpu" for t in (x, gn_scales, gn_biases)) and p.device.type == "cpu":
        return resblock_tower_gn_plain(
            x, p.weights, p.biases, gn_scales, gn_biases, kernel_sizes=p.kernel_sizes,
            dilation_sizes=p.dilation_sizes, resblock=p.resblock, num_groups=num_groups, epsilon=epsilon,
            lengths=lengths,
        )
    _check_call(x, p, "resblock_tower_gn")
    _check_no_grad("resblock_tower_gn", p, x, gn_scales, gn_biases)
    B, C, T = x.shape
    G = len(p.kernel_sizes)
    if tuple(gn_scales.shape) != (G, C) or tuple(gn_biases.shape) != (G, C) or C % num_groups:
        raise ValueError(f"resblock_tower_gn: GroupNorm params {tuple(gn_scales.shape)}, {num_groups} groups")
    if gn_scales.device != x.device or gn_biases.device != x.device:
        raise ValueError("resblock_tower_gn: GroupNorm params on another device")
    if B == 0 or T == 0:
        return torch.empty_like(x)
    L = None if lengths is None else clamp_lengths(lengths, B, T, x.device)
    count_tiles(lengths, B, T, gn_tile(p), uses_fma_gn(p.dtype, C))
    outs, mom = gn_tower_chains(x, p, L)
    A, K = gn_affines_cuda(mom, gn_scales, gn_biases, num_groups, epsilon, T, L)
    return gn_apply_cuda(outs, A, K, L)


# ---------------------------------------------------------------- K4 in passes, for time shards


def gn_tile(packed: PackedTower) -> int:
    """The time steps of one K4 block (``TT``) for these operands: K4 sums its
    moments tile by tile, ``[t TT, (t + 1) TT)``, whatever ``T``."""
    return tower_geometry(packed, gn=True)[0]


def tile_moments_plain(rs: Sequence[torch.Tensor], TT: int) -> torch.Tensor:
    """The per-tile partial moments ``[B, nT, C, n_mom]`` (order as
    :func:`moments`) of chain outputs ``[B, C, T]``: tile ``t`` sums the time
    steps ``[t TT, (t + 1) TT)``, in f32."""
    B, C, T = rs[0].shape
    nT = -(-T // TT)
    f = [F.pad(r.float(), (0, nT * TT - T)).reshape(B, C, nT, TT) for r in rs]
    cols = [r.sum(dim=3) for r in f]
    for g in range(len(f)):
        for h in range(g, len(f)):
            cols.append((f[g] * f[h]).sum(dim=3))
    return torch.stack(cols, dim=3).transpose(1, 2).contiguous()


def gn_tower_partials(x: torch.Tensor, packed: PackedTower, lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's pass 1 alone: ``(chain outputs [G, B, C, T], per-tile partial
    moments [B, nT, C, n_mom])`` of ``x [B, C, T]``, tiles of :func:`gn_tile`
    steps; the kernel (:func:`gn_tower_chains`) for CUDA tensors, the plain
    chains and :func:`tile_moments_plain` for CPU tensors. :func:`moments_reduce`
    sums the partials."""
    if x.device.type == "cpu" and packed.device.type == "cpu":
        return gn_tower_partials_plain(x, packed, lengths)
    _check_no_grad("resblock_tower_gn", packed, x)
    B, C, T = x.shape
    count_tiles(lengths, B, T, gn_tile(packed), uses_fma_gn(packed.dtype, C))
    return gn_tower_chains(x, packed, None if lengths is None else clamp_lengths(lengths, B, T, x.device),
                           partials=True)


def gn_tower_partials_plain(x: torch.Tensor, packed: PackedTower, lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gn_tower_partials`'s function: the chains with ``F.conv1d`` and
    :func:`tile_moments_plain` of them, on any device."""
    B, C, T = x.shape
    mask = None if lengths is None else frame_mask(clamp_lengths(lengths, B, T, x.device), T)
    rs = _chains(x, packed.weights, packed.biases, packed.dilation_sizes, packed.resblock, mask)
    return torch.stack(rs), tile_moments_plain(rs, gn_tile(packed))


def moments_reduce_plain(part: torch.Tensor) -> torch.Tensor:
    """:func:`moments_reduce`'s function: the tiles added one by one in order, in f32."""
    B, nT, C, n_mom = part.shape
    mom = torch.zeros((B, C, n_mom), dtype=torch.float32, device=part.device)
    for t in range(nT):
        mom = mom + part[:, t]
    return mom


def moments_reduce(part: torch.Tensor) -> torch.Tensor:
    """Per-tile partial moments ``[B, nT, C, n_mom]`` summed over the tiles in
    order, in f32 -> ``[B, C, n_mom]``: ``moments_reduce_kernel`` for CUDA
    tensors (the bits of K4's own reduction), :func:`moments_reduce_plain` for
    CPU tensors."""
    if part.device.type == "cpu":
        return moments_reduce_plain(part)
    if part.dtype != torch.float32 or not part.is_contiguous():
        raise ValueError("moments_reduce: part must be a contiguous f32 CUDA tensor")
    B, nT, C, n_mom = part.shape
    mom = torch.empty((B, C, n_mom), dtype=torch.float32, device=part.device)
    rc = load_library().acad_moments_reduce(part.data_ptr(), mom.data_ptr(), B, nT, C * n_mom,
                                            torch.cuda.current_stream(part.device).cuda_stream)
    check(rc, "moments_reduce")
    return mom


def gn_tower_affines(mom: torch.Tensor, gn_scales: torch.Tensor, gn_biases: torch.Tensor, num_groups: int,
                     epsilon: float, T: int, lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's pass 2a alone: the affines ``(A [G, B, C], K [B, C])`` from moments
    that count ``T`` frames, or with ``lengths [B]`` each row's ``lengths[b]``
    clamped to ``[0, T]``; ``gn_affine_kernel`` for CUDA tensors,
    :func:`gn_affines` for CPU tensors."""
    if mom.device.type == "cpu":
        count = T if lengths is None else clamp_lengths(lengths, mom.shape[0], T, mom.device)
        return gn_affines(mom, gn_scales, gn_biases, num_groups, epsilon, count)
    return gn_affines_cuda(mom, gn_scales, gn_biases, num_groups, epsilon, T, lengths)


def gn_tower_apply(rs: torch.Tensor, A: torch.Tensor, K: torch.Tensor, lengths=None) -> torch.Tensor:
    """K4's pass 2b alone on ``rs [G, B, C, T]``; ``gn_apply_kernel`` for CUDA
    tensors, :func:`gn_apply` for CPU tensors."""
    if rs.device.type == "cpu":
        L = None if lengths is None else clamp_lengths(lengths, rs.shape[1], rs.shape[3], rs.device)
        return gn_apply(list(rs), A, K, L)
    return gn_apply_cuda(rs, A, K, lengths)
