"""The yardstick's arithmetic: the card's peaks, kernel groups by name, each
kernel's least time at its call's shapes, and the model FLOPs of a call.

Frozen copies, so that a change to the program cannot move them:
``GROUPS`` of ``profile_port.GROUPS`` (plus a group for copies), the tower
bound of ``chip_smoke._tower_bound``, and the K1/K2 bounds of PERF.md's
kernel table. The least time of a call is the larger of its operations at
the peak for their type and its bytes at the HBM rate, each input byte read
once and each output byte written once.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

# NVIDIA H100 SXM data sheet, dense (700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # float32: outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("k1_rvq", ("rvq_encode_kernel", "embed_sqnorm_kernel", "embed_tiles_kernel")),
    ("k2_lstm2", ("lstm2_kernel",)),
    ("k4_gn_tower", ("gn_tower_kernel", "gn_tower_fma_kernel", "moments_reduce_kernel",
                     "gn_affine_kernel", "gn_apply_kernel")),
    ("k3_tower", ("tower_kernel", "tower_fma_kernel")),
    ("memcpy", ("Memcpy", "Memset")),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "Conv", "winograd", "fft", "implicit")),
    ("gemm", ("gemm", "Gemm", "nvjet", "cutlass", "xmma")),
)
OTHER = "elementwise"  # elementwise, pad, reduce, layout copies


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER


def least_ms(flops: float, nbytes: float, peak: float) -> float:
    """The least time in ms: operations at ``peak`` or bytes at the HBM rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3


def k1_rvq_ms(n: int, k: int, d: int, n_q: int) -> float:
    """K1: ``2 N K D n_q`` f32 FMAs at the f32 peak; x and the codebooks read, codes written."""
    return least_ms(2.0 * n * k * d * n_q, 4.0 * (n * d + n_q * k * d + n_q * n), PEAK_FLOPS["float32"])


def k2_lstm2_ms(T: int, B: int, H: int, dtype: str) -> float:
    """K2: the three recurrent products ``[4H, H]`` a step for T steps at the weights'
    peak; x_proj f32 read, the weights read, y written in the weights' dtype."""
    item = 2 if dtype == "bfloat16" else 4
    flops = 2.0 * T * B * 3 * 4 * H * H
    nbytes = 4.0 * T * B * 4 * H + item * (3 * 4 * H * H + T * B * H)
    return least_ms(flops, nbytes, PEAK_FLOPS[dtype])


def chain_taps(kernel_sizes: Sequence[int], dilation_sizes: Sequence[Sequence[int]]) -> int:
    """Taps of a ResBlock1 tower: two convs of ``k`` taps per dilation, per chain."""
    return sum(k * 2 * len(ds) for k, ds in zip(kernel_sizes, dilation_sizes))


def tower_ms(B: int, C: int, T: int, kernel_sizes, dilation_sizes, dtype: str, c_post: int = 0, kp: int = 0,
             frames: float = None) -> float:
    """K3/K4: the towers' convs (and a fused ``conv_post`` of ``c_post`` outputs and
    ``kp`` taps) over ``frames`` valid frames in all (``B * T`` when None); the input
    and output of those frames and the weights move once."""
    item = 2 if dtype == "bfloat16" else 4
    taps = chain_taps(kernel_sizes, dilation_sizes)
    frames = B * T if frames is None else frames
    flops = 2.0 * frames * C * C * taps + 2.0 * frames * C * c_post * kp
    nbytes = item * (frames * C + frames * (c_post or C) + C * C * taps + c_post * C * kp)
    return least_ms(flops, nbytes, PEAK_FLOPS[dtype])


def count_flops(fn: Callable[[], object]) -> float:
    """The operations of ``fn`` as ``torch.utils.flop_counter`` counts them (run it on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def meta_state_dict(specs: Dict) -> Dict[str, torch.Tensor]:
    """Shape-only tensors for a reference built to count operations."""
    return {name: torch.empty(shape, device="meta") for name, (shape, _, _) in specs.items()}
