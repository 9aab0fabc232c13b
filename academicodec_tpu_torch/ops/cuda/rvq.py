"""Residual-VQ encode: the hand-written CUDA kernel (``csrc/rvq.cu``) and its plain version.

Replaces the TPU kernel ``academicodec_tpu/ops/pallas/rvq.py:_rvq_kernel``
(``rvq_encode_fused``). Each row of ``x [N, D]`` is quantized greedily
through ``n_q`` codebooks ``[n_q, K, D]``: per layer the nearest row by
``|r|^2 - 2 r.e + |e|^2`` (lowest index on ties), then the chosen row is
subtracted from the residual.

On the H100 this is bound by operations: ``2 N K D n_q`` f32 FMAs (100.7
GFLOP at the flagship shape, 1.5 ms at the 67 TFLOP/s f32 peak) against
about 42 MB of traffic, so the kernel is built to keep the FMA pipes fed.
A pre-pass copies the codebooks into tile order (each [16 dims x 256
codes] tile one contiguous 16 KB block). Each block keeps a 64-row residual
tile in shared memory across all layers; the tiles stream through a
four-stage ring, one TMA bulk copy per tile issued two tiles ahead, so the
SM spends no instructions on the copy and the warps release stages on
mbarriers instead of meeting at a block barrier after every tile; each
thread holds an 8-row x 8-code tile of dot products in registers (64 FMAs
per 4 single-wavefront shared loads, double-buffered in registers) and a
running ``(min, index)`` per row; the chosen row is subtracted by a gather.
Distances are exact f32 FMA (no TF32), so tokens match the plain version up
to near-ties in summation order.

``rvq_encode`` runs the kernel for CUDA tensors and the plain version only
for CPU tensors. Each launch adds one to the counter ``k1.launches``
(``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES, check, load_library
from academicodec_tpu_torch.utils import profiling

# rows per block, dims and codes per codebook tile, and ring stages of
# csrc/rvq.cu
TILE_ROWS, D_CHUNK, CODE_CHUNK, STAGES = 64, 16, 256, 4


def rvq_smem_bytes(d: int) -> int:
    """Shared memory of one block of csrc/rvq.cu at dimension ``d``: two
    mbarriers per ring stage, the dims-major residual tile [ceil(D / D_CHUNK)
    * D_CHUNK, TILE_ROWS + 4] f32, the ring [STAGES, D_CHUNK, CODE_CHUNK]
    f32, and per row 4 candidate (min, index) pairs and |r|^2."""
    dp = -(-d // D_CHUNK) * D_CHUNK
    return 16 * STAGES + 4 * (dp * (TILE_ROWS + 4) + STAGES * D_CHUNK * CODE_CHUNK + 9 * TILE_ROWS)


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
    if rvq_smem_bytes(d) > MAX_SMEM_BYTES:
        raise ValueError(f"rvq_encode: D={d} does not fit the shared-memory residual tile")
    x = x.float().contiguous()
    embed = embed.float().contiguous()
    codes = torch.empty((n_q, n), dtype=torch.int32, device=x.device)
    if n == 0 or n_q == 0:
        return codes
    enorm = torch.empty((n_q, k), dtype=torch.float32, device=x.device)
    # the codebooks in tile order [n_q, K / CODE_CHUNK, D / D_CHUNK, D_CHUNK, CODE_CHUNK]
    tiles = torch.empty((n_q, -(-k // CODE_CHUNK) * CODE_CHUNK * -(-d // D_CHUNK) * D_CHUNK),
                        dtype=torch.float32, device=x.device)
    rc = load_library().acad_rvq_encode(
        x.data_ptr(), embed.data_ptr(), tiles.data_ptr(), enorm.data_ptr(), codes.data_ptr(),
        n, d, n_q, k, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "rvq_encode")
    profiling.count("k1.launches")
    return codes
