"""HiFi-GAN resblock towers: the hand-written CUDA kernels (``csrc/resblock.cu``)
and their plain versions.

K3 ``resblock_tower`` replaces the TPU kernel
``academicodec_tpu/ops/pallas/resblock.py:_tower_kernel`` (``resblock_tower``):
the mean of G residual chains over one generator stage ``x [B, C, T]``, with
an optional lrelu -> conv_post -> tanh epilogue. K4 ``resblock_tower_gn``
replaces ``_gn_tower_kernel`` (``resblock_tower_gn``): every chain of an
encoder stage from the same input plus the per-channel moments, then pass 2
(plain PyTorch on ``[B, C]`` scalars, as in the JAX package) derives the
chained GroupNorm affines ``xs_g = GN_g(xs_{g-1} + r_g)`` and applies one
elementwise recombination.

Chains follow the JAX call order: ResBlock1 convs ``(k, d0), (k, 1), (k, d1),
(k, 1), ...`` in pairs with a residual add per pair, ResBlock2 one conv per
add. Rounding points are the Pallas kernel's: lrelu in f32 rounded to the
storage dtype, the first conv of a pair rounded, the residual add in f32
then rounded, chain sums and means in f32.

On the H100 both are bound by operations: 0.99 TFLOP for a flagship
``[8, 64, 120000]`` stage (1.0 ms at the bf16 tensor-core peak) against
0.25-0.5 GB of traffic. The kernels keep a halo'd time window of all
channels in shared memory for the whole tower and compute only the columns
still valid after each conv: on the bf16 tensor cores (mma.sync) for bf16
with C % 16 == 0, in f32 FMAs otherwise (see the source for the design).

Wrappers take ``[B, C, T]`` activations and torch ``[O, I, K]`` weights. CPU
tensors run the plain version; CUDA tensors always launch the kernel or
raise. ``TOWER_LAUNCHES`` and ``GN_TOWER_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES, check, load_library

TOWER_LAUNCHES = 0
GN_TOWER_LAUNCHES = 0

LRELU_SLOPE = 0.1
# limits of csrc/resblock.cu: chains per tower, convs per chain, output
# channels per thread, columns per warp unit
MAX_CHAINS, MAX_CONVS, CO_TILE, STRIP = 4, 8, 8, 256

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


# ---------------------------------------------------------------- plain versions


def _lrelu(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.leaky_relu(v.float(), LRELU_SLOPE).to(dtype)


def _conv(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-"same" conv in f32 of storage-dtype input and weights."""
    k = w.shape[-1]
    return F.conv1d(a.float(), w.to(a.dtype).float(), b.float(), padding=(k - 1) // 2 * d, dilation=d)


def _chain(x: torch.Tensor, ws, bs, dils: Sequence[int], resblock: str) -> torch.Tensor:
    dt = x.dtype
    cur = x
    if resblock == "1":
        for p in range(0, len(dils), 2):
            y1 = _conv(_lrelu(cur, dt), ws[p], bs[p], dils[p]).to(dt)
            y2 = _conv(_lrelu(y1, dt), ws[p + 1], bs[p + 1], dils[p + 1])
            cur = (cur.float() + y2).to(dt)
    else:
        for p, d in enumerate(dils):
            cur = (cur.float() + _conv(_lrelu(cur, dt), ws[p], bs[p], d)).to(dt)
    return cur


def _chains(x, weights, biases, dilation_sizes, resblock) -> List[torch.Tensor]:
    return [
        _chain(x, weights[g], biases[g], chain_conv_dilations(ds, resblock), resblock)
        for g, ds in enumerate(dilation_sizes)
    ]


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
) -> torch.Tensor:
    """K3's function with ``F.conv1d``, rounding where the kernel rounds."""
    dt = x.dtype
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


def gn_recombine(
    rs: Sequence[torch.Tensor],
    mom: torch.Tensor,
    gn_scales: torch.Tensor,
    gn_biases: torch.Tensor,
    num_groups: int,
    epsilon: float,
) -> torch.Tensor:
    """Pass 2 of K4: the chained GroupNorm affines from the moments, then
    ``out = sum_g A_g r_g / G + K / G`` (academicodec_tpu/ops/pallas/
    resblock.py:585-631, operation for operation)."""
    G = len(rs)
    B, C, T = rs[0].shape
    m = [mom[:, :, g] for g in range(G)]
    q = {}
    col = G
    for g in range(G):
        for h in range(g, G):
            q[(g, h)] = q[(h, g)] = mom[:, :, col]
            col += 1
    gsize = C // num_groups
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
    inv = 1.0 / float(G)
    out = K[:, :, None] * inv
    for g in range(G):
        out = out + (A[g] * inv)[:, :, None] * rs[g].float()
    return out.to(rs[0].dtype)


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
) -> torch.Tensor:
    """K4's function: the chains with ``F.conv1d``, moments of the rounded
    chain outputs, then :func:`gn_recombine`."""
    rs = _chains(x, weights, biases, dilation_sizes, resblock)
    return gn_recombine(rs, moments(rs), gn_scales, gn_biases, num_groups, epsilon)


# ---------------------------------------------------------------- kernel wrappers


def uses_mma(dtype: torch.dtype, C: int) -> bool:
    """Whether the kernel's convs run on the bf16 tensor cores (else f32 FMAs)."""
    return dtype == torch.bfloat16 and C % 16 == 0


def row_stride(width: int, mma: bool) -> int:
    """Shared-memory row stride of a window (``row_stride`` in csrc/resblock.cu)."""
    return -(-width // 64) * 64 + 8 if mma else -(-width // 8) * 8


def pick_tile(C: int, H: int, post_halo: int, itemsize: int, with_acc: bool,
              mma: bool = False) -> Tuple[int, int]:
    """``(TT, shared bytes)``: output columns per block. The window
    ``TT + 2H`` is ``64 // C`` 256-column strips where they fit (8 warps x 8
    channels busy), else the widest multiple of 8 columns that fits shared
    memory (at least 16 output columns)."""
    least = 2 * H + 16
    top = max(-(-least // STRIP), 64 // C) * STRIP
    for width in range(top, least - 1, -8):
        tt = width - 2 * H
        smem = 3 * C * row_stride(width, mma) * itemsize
        if with_acc:
            smem += C * (tt + 2 * post_halo) * 4
        if smem <= MAX_SMEM_BYTES:
            return tt, smem
    raise ValueError(f"resblock tower: C={C} with halo {H} does not fit in shared memory")


def _fragment_order(w: torch.Tensor) -> torch.Tensor:
    """``[O, I, K]`` -> mma.sync m16n8k16 A fragments ``[K][O/16][I/16][lane][8]``:
    lane = 4 gid + tig holds rows (gid, gid + 8) x columns (2 tig, 2 tig + 1,
    2 tig + 8, 2 tig + 9) of each 16 x 16 tile, in register order."""
    O, I, K = w.shape
    v = w.permute(2, 0, 1).reshape(K, O // 16, 2, 8, I // 16, 2, 4, 2)  # j mt rh gid kt ch tig p
    return v.permute(0, 1, 4, 3, 6, 5, 2, 7).reshape(-1)  # j mt kt gid tig ch rh p


def _check_and_pack(x, weights, biases, kernel_sizes, dilation_sizes, resblock, name):
    """Validate a CUDA call and pack the weights in ``x.dtype`` (fragment
    order for the tensor-core path, ``[C_in][k][C_out]`` for the FMA path)
    and the biases f32, chain after chain in call order; returns them with
    the C ``spec`` array."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: x on {dev}; the kernel takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: no kernel for {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, C, T] tensor")
    B, C, T = x.shape
    if C % CO_TILE or C == 0:
        raise ValueError(f"{name}: C={C} must be a positive multiple of {CO_TILE}")
    G = len(kernel_sizes)
    if not (1 <= G <= MAX_CHAINS) or len(dilation_sizes) != G or len(weights) != G or len(biases) != G:
        raise ValueError(f"{name}: {G} chains (the kernel takes 1..{MAX_CHAINS})")
    if resblock not in ("1", "2"):
        raise ValueError(f"{name}: resblock {resblock!r}")
    mma = uses_mma(x.dtype, C)
    spec = [0] * (3 + 2 * MAX_CHAINS + MAX_CHAINS * MAX_CONVS)
    spec[0], spec[1], spec[2] = int(mma), G, int(resblock)
    ws, bs = [], []
    for g, (k, ds) in enumerate(zip(kernel_sizes, dilation_sizes)):
        dils = chain_conv_dilations(ds, resblock)
        if k % 2 == 0 or len(dils) > MAX_CONVS or len(weights[g]) != len(dils) or len(biases[g]) != len(dils):
            raise ValueError(f"{name}: chain {g}: k={k}, {len(dils)} convs, {len(weights[g])} weights")
        spec[3 + g], spec[3 + MAX_CHAINS + g] = k, len(dils)
        for i, d in enumerate(dils):
            spec[3 + 2 * MAX_CHAINS + g * MAX_CONVS + i] = d
            w, b = weights[g][i], biases[g][i]
            if tuple(w.shape) != (C, C, k) or tuple(b.shape) != (C,) or w.device != dev or b.device != dev:
                raise ValueError(f"{name}: chain {g} conv {i}: weight {tuple(w.shape)} on {w.device}")
            w = w.to(x.dtype)
            ws.append(_fragment_order(w) if mma else w.permute(1, 2, 0).reshape(-1))
            bs.append(b.float().reshape(-1))
    return torch.cat(ws).contiguous(), torch.cat(bs).contiguous(), (ctypes.c_int * len(spec))(*spec)


def resblock_tower(
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
) -> torch.Tensor:
    """Mean of the resblock chains over ``x [B, C, T]`` -> ``[B, C, T]``, or
    with ``post_weight [C_post, C, kp]``: ``(tanh)(conv(lrelu(mean)))`` ->
    ``[B, C_post, T]``. ``weights[g][i]`` is conv ``i`` of chain ``g``,
    ``[C, C, k]``; ``biases[g][i]`` is ``[C]``."""
    kw = dict(kernel_sizes=kernel_sizes, dilation_sizes=dilation_sizes, resblock=resblock)
    tensors = [x, *(t for ch in weights for t in ch), *(t for ch in biases for t in ch)]
    tensors += [t for t in (post_weight, post_bias) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return resblock_tower_plain(
            x, weights, biases, post_weight=post_weight, post_bias=post_bias, post_tanh=post_tanh, **kw
        )
    w_all, b_all, spec = _check_and_pack(x, weights, biases, kernel_sizes, dilation_sizes, resblock,
                                         "resblock_tower")
    B, C, T = x.shape
    Hc = tower_halo(kernel_sizes, dilation_sizes, resblock)
    c_out, kp, wp, bp = C, 1, None, None
    if post_weight is not None:
        c_out, c_in, kp = post_weight.shape
        if c_in != C or kp % 2 == 0 or post_weight.device != x.device:
            raise ValueError(f"resblock_tower: post weight {tuple(post_weight.shape)} for C={C}")
        wp = post_weight.to(x.dtype).contiguous()
        bp = (post_bias if post_bias is not None else torch.zeros(c_out, device=x.device)).float().contiguous()
        if tuple(bp.shape) != (c_out,) or bp.device != x.device:
            raise ValueError(f"resblock_tower: post bias {tuple(bp.shape)}")
    P = (kp - 1) // 2
    H = Hc + P
    TT, _ = pick_tile(C, H, P, x.element_size(), with_acc=True, mma=uses_mma(x.dtype, C))
    y = torch.empty((B, c_out, T), dtype=x.dtype, device=x.device)
    if B == 0 or T == 0:
        return y
    rc = load_library().acad_resblock_tower(
        x.data_ptr(), w_all.data_ptr(), b_all.data_ptr(),
        None if wp is None else wp.data_ptr(), None if bp is None else bp.data_ptr(),
        y.data_ptr(), spec, B, C, T, TT, H, Hc, c_out, kp, int(post_tanh),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "resblock_tower")
    global TOWER_LAUNCHES
    TOWER_LAUNCHES += 1
    return y


def resblock_tower_gn(
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
) -> torch.Tensor:
    """Encoder resblock bundle over ``x [B, C, T]`` (reference
    models.py:405-416): ``xs_0 = GN_0(r_0)``, ``xs_g = GN_g(xs_{g-1} + r_g)``,
    ``out = xs_last / G``, every chain ``r_g`` reading ``x``.
    ``gn_scales``/``gn_biases`` are ``[G, C]``."""
    kw = dict(kernel_sizes=kernel_sizes, dilation_sizes=dilation_sizes, resblock=resblock)
    tensors = [x, gn_scales, gn_biases, *(t for ch in weights for t in ch), *(t for ch in biases for t in ch)]
    if all(t.device.type == "cpu" for t in tensors):
        return resblock_tower_gn_plain(
            x, weights, biases, gn_scales, gn_biases, num_groups=num_groups, epsilon=epsilon, **kw
        )
    w_all, b_all, spec = _check_and_pack(x, weights, biases, kernel_sizes, dilation_sizes, resblock,
                                         "resblock_tower_gn")
    B, C, T = x.shape
    G = len(kernel_sizes)
    if tuple(gn_scales.shape) != (G, C) or tuple(gn_biases.shape) != (G, C) or C % num_groups:
        raise ValueError(f"resblock_tower_gn: GroupNorm params {tuple(gn_scales.shape)}, {num_groups} groups")
    if gn_scales.device != x.device or gn_biases.device != x.device:
        raise ValueError("resblock_tower_gn: GroupNorm params on another device")
    H = tower_halo(kernel_sizes, dilation_sizes, resblock)
    TT, _ = pick_tile(C, H, 0, x.element_size(), with_acc=False, mma=uses_mma(x.dtype, C))
    if B == 0 or T == 0:
        return torch.empty_like(x)
    n_mom = G + G * (G + 1) // 2
    nT = -(-T // TT)
    outs = torch.empty((G, B, C, T), dtype=x.dtype, device=x.device)
    part = torch.empty((B, nT, C, n_mom), dtype=torch.float32, device=x.device)
    mom = torch.empty((B, C, n_mom), dtype=torch.float32, device=x.device)
    rc = load_library().acad_resblock_tower_gn(
        x.data_ptr(), w_all.data_ptr(), b_all.data_ptr(), outs.data_ptr(), part.data_ptr(),
        mom.data_ptr(), spec, B, C, T, TT, H, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "resblock_tower_gn")
    global GN_TOWER_LAUNCHES
    GN_TOWER_LAUNCHES += 1
    return gn_recombine(list(outs), mom, gn_scales, gn_biases, num_groups, epsilon)
