"""W8A8 int8 convolution for HiFi-Codec serving.

The scheme of ``academicodec_tpu/ops/int8.py``: weights quantized per out
channel with symmetric scales, from the resolved kernel on every call;
activations with one static per-tensor scale, calibrated as max |x| / 127
(``nn/conv.Conv1d(w8a8=True)``); rounding half to even, clipping to +-127,
zero padding only (0 is exact in the int8 domain), int32 accumulation and
one dequantizing multiply by ``act_scale * w_scale[cout]``.

:func:`conv1d_int32` computes the int32 sums. For CUDA tensors it runs the
int8 x int8 -> int32 GEMM of cuBLASLt (``torch._int_mm``) on an int8 im2col
of the input, with K and N padded to multiples of 8 and M to more than 16
rows by zeros, which is exact; for CPU tensors its plain version convolves
in f64, which is exact for these sums (at hificodec_24k_320d's widest int8
conv they reach 11 * 512 * 127^2 ~ 9.1e7, past f32's 2^24, far below f64's
2^53). The JAX package computes this conv with ``lax.conv_general_dilated``
outside any Pallas kernel, so the library GEMM stands where it stood.
Each GEMM launched adds one to the counter ``int8.gemms``
(``utils/profiling.py``).

Behavioral parity target: academicodec_tpu/ops/int8.py:38-100.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from academicodec_tpu_torch.utils import profiling

_MIN_ROWS = 17  # torch._int_mm on CUDA needs more than 16 rows


def quantize_kernel_per_cout(weight: torch.Tensor, eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 quantization of a ``[O, I, K]`` kernel:
    ``(weight_i8 [O, I, K] int8, scale [O] f32)`` with ``weight ~ weight_i8 * scale``."""
    wf = weight.float()
    scale = wf.abs().amax(dim=(1, 2)).clamp_min(eps) / 127.0
    return torch.round(wf / scale[:, None, None]).clamp(-127, 127).to(torch.int8), scale


def quantize_act(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantization with a static scalar scale;
    values past ``127 * act_scale`` clip."""
    return torch.round(x.float() / act_scale).clamp(-127, 127).to(torch.int8)


def act_scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """The activation scale of a calibrated max |x| (f32 scalar)."""
    return amax.float().clamp_min(1e-12) / 127.0


def conv1d_int32_plain(xi: torch.Tensor, wi: torch.Tensor, stride: int = 1, dilation: int = 1,
                       padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The int32 sums of ``xi [B, C, T]`` int8 by ``wi [O, C, K]`` int8, convolved in f64 (exact)."""
    y = F.conv1d(F.pad(xi.double(), padding), wi.double(), stride=stride, dilation=dilation)
    return y.to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv1d_int32(xi: torch.Tensor, wi: torch.Tensor, stride: int = 1, dilation: int = 1,
                 padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """int8 ``xi [B, C, T]`` by int8 ``wi [O, C, K]`` -> int32 ``[B, O, T_out]``:
    cuBLASLt's int8 GEMM for CUDA tensors, the plain version for CPU tensors."""
    if xi.device.type == "cpu" and wi.device.type == "cpu":
        return conv1d_int32_plain(xi, wi, stride, dilation, padding)
    if xi.device.type != "cuda" or wi.device != xi.device:
        raise ValueError(f"conv1d_int32: tensors on {xi.device} and {wi.device}")
    if xi.dtype != torch.int8 or wi.dtype != torch.int8:
        raise ValueError(f"conv1d_int32: int8 operands, got {xi.dtype} and {wi.dtype}")
    B, C, _ = xi.shape
    O, Ci, K = wi.shape
    if Ci != C:
        raise ValueError(f"conv1d_int32: input of {C} channels, kernel of {Ci}")
    xp = F.pad(xi, padding)
    span = dilation * (K - 1) + 1
    t_out = (xp.shape[2] - span) // stride + 1
    # im2col [B * T_out, C * K], flattened as the kernel's [O, C * K]
    cols = xp.unfold(2, span, stride)[..., ::dilation].permute(0, 2, 1, 3).reshape(B * t_out, C * K)
    m, kd = cols.shape
    kd8 = _round_up(kd, 8)
    cols = F.pad(cols, (0, kd8 - kd, 0, max(0, _MIN_ROWS - m)))
    w = F.pad(wi.reshape(O, kd), (0, kd8 - kd, 0, _round_up(O, 8) - O))
    y = torch._int_mm(cols, w.t())
    profiling.count("int8.gemms")
    return y[:m, :O].reshape(B, t_out, O).permute(0, 2, 1)


def conv1d_w8a8(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], act_scale: torch.Tensor, *,
                stride: int = 1, dilation: int = 1, padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """int8 x int8 -> int32 convolution of ``x [B, C, T]`` by ``weight [O, C, K]``.

    ``x`` is float (quantized here with ``act_scale``) or already int8 (then
    ``act_scale`` only dequantizes). The output has ``x``'s float dtype, f32
    for an int8 ``x``."""
    if x.dtype == torch.int8:
        xi, out_dtype = x, torch.float32
    else:
        xi, out_dtype = quantize_act(x, act_scale), x.dtype
    wi, w_scale = quantize_kernel_per_cout(weight)
    yi = conv1d_int32(xi, wi, stride, dilation, padding)
    y = yi.float() * (act_scale * w_scale)[:, None]
    if bias is not None:
        y = y + bias.float()[:, None]
    return y.to(out_dtype)
