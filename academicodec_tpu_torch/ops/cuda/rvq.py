"""Residual-VQ encode: the hand-written CUDA kernel (``csrc/rvq.cu``) and its plain version.

Replaces the TPU kernel ``academicodec_tpu/ops/pallas/rvq.py:_rvq_kernel``
(``rvq_encode_fused``). Each row of ``x [N, D]`` is quantized greedily
through ``n_q`` codebooks ``[n_q, K, D]``: per layer the nearest row by
``|r|^2 - 2 r.e + |e|^2`` (lowest index on ties), then the chosen row is
subtracted from the residual.

On the H100 this is bound by operations: ``2 N K D n_q`` f32 FMAs (100.7
GFLOP at the flagship shape, 1.5 ms at the 67 TFLOP/s f32 peak) against
about 42 MB of traffic. The kernel keeps each block's residual tile in
shared memory across all layers, streams each codebook through shared
memory in chunks with a running ``(min, index)`` per row, and subtracts the
chosen row by a gather. Distances are exact f32 FMA (no TF32), so tokens
match the plain version up to near-ties in summation order.

``rvq_encode`` runs the kernel for CUDA tensors and the plain version only
for CPU tensors. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES, check, load_library

LAUNCHES = 0

# rows per block and padded-dim chunk of csrc/rvq.cu; the residual tile
# [TILE_ROWS, ceil(D / D_CHUNK) * D_CHUNK] f32 lives in shared memory
TILE_ROWS, D_CHUNK = 32, 32


def l2_distance_argmin(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Nearest codebook row for each row of ``x [N, D]`` in ``embed [K, D]``:
    ``argmin(|x|^2 - 2 x.e + |e|^2)``, lowest index on ties -> ``[N]`` int64."""
    dist = (
        x.square().sum(dim=1, keepdim=True)
        - 2.0 * torch.matmul(x, embed.t())
        + embed.square().sum(dim=1)
    )
    return dist.argmin(dim=1)


def rvq_encode_plain(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``x [N, D]``, ``embed [n_q, K, D]`` -> codes ``[n_q, N]`` int32, in f32."""
    residual = x.float()
    embed = embed.float()
    codes = []
    for e in embed:
        idx = l2_distance_argmin(residual, e)
        codes.append(idx.to(torch.int32))
        residual = residual - e[idx]
    if not codes:
        return torch.empty((0, x.shape[0]), dtype=torch.int32, device=x.device)
    return torch.stack(codes)


def rvq_encode(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Residual-VQ encode ``x [N, D]`` against ``embed [n_q, K, D]`` -> codes
    ``[n_q, N]`` int32. Inputs are taken in f32."""
    if x.device.type == "cpu" and embed.device.type == "cpu":
        return rvq_encode_plain(x, embed)
    if x.device.type != "cuda" or embed.device != x.device:
        raise ValueError(f"rvq_encode: x on {x.device}, embed on {embed.device}")
    if x.dim() != 2 or embed.dim() != 3 or embed.shape[2] != x.shape[1]:
        raise ValueError(f"rvq_encode: shapes {tuple(x.shape)} and {tuple(embed.shape)}")
    n, d = x.shape
    n_q, k, _ = embed.shape
    d_pad = -(-d // D_CHUNK) * D_CHUNK
    if TILE_ROWS * d_pad * 4 + 20 * 1024 > MAX_SMEM_BYTES:
        raise ValueError(f"rvq_encode: D={d} does not fit the shared-memory residual tile")
    x = x.float().contiguous()
    embed = embed.float().contiguous()
    codes = torch.empty((n_q, n), dtype=torch.int32, device=x.device)
    if n == 0 or n_q == 0:
        return codes
    enorm = torch.empty((n_q, k), dtype=torch.float32, device=x.device)
    rc = load_library().acad_rvq_encode(
        x.data_ptr(), embed.data_ptr(), enorm.data_ptr(), codes.data_ptr(),
        n, d, n_q, k, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "rvq_encode")
    global LAUNCHES
    LAUNCHES += 1
    return codes
