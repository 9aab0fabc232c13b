"""The Snake epilogue of a bias-free conv: the hand-written CUDA kernel (``csrc/snake.cu``) and its plain version.

Replaces no TPU kernel (the JAX package runs no Snake-activated model); it
serves the Descript Audio Codec's towers (``nn/dac.py``). One call computes,
per element of a conv output ``h`` of channel ``c``,

    s = h + bias[c] (+ residual)
    y = s + (alpha[c] + 1e-9)^-1 * sin(alpha[c] * s)^2

DAC's ``Snake1d`` on the sum, in f32 whatever the tensors' dtype (bf16, f16
or f32), and returns ``y`` and, where asked (a later residual add reads it),
``s``, both in ``h``'s dtype. Layouts: ``[B, C, T]`` contiguous, or the
channels-last ``[B, C, 1, T]`` of the towers' 16-bit route, whose batch rows may
be strided (a view of the first ``T`` frames of a longer conv output);
there ``frames`` gives ``y`` more frames than ``h`` a row, written as zeros
(the zero padding of a dilated conv run as its phases, ``nn/conv.py``).

On the H100 the kernel is bound by bytes (the source says how it is built
for that); its sine is the hardware one on an argument reduced to
[-pi/2, pi/2], within ~4e-7 of torch's. ``snake`` launches the kernel for
CUDA tensors and runs the plain version for any other device (the CPU, the
meta device); the kernel has no backward, so a CUDA call that autograd would
record raises, and the towers run the plain version under autograd. Each
launch adds one to the counter ``snake.launches`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from academicodec_tpu_torch.ops.cuda.build import check, load_library
from academicodec_tpu_torch.utils import profiling

ALPHA_EPS = 1e-9  # DAC's, in front of the reciprocal
MAX_CHANNEL_VECTORS = 512  # csrc/snake.cu: one block a frame group, one thread a channel vector
VECTOR_BYTES = 16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # csrc/snake.cu acad_snake's dtype


def snake_plain(h: torch.Tensor, alpha: torch.Tensor, bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None, keep_sum: bool = False,
                frames: Optional[int] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The epilogue in plain PyTorch (module docstring), differentiable: ``h``
    ``[B, C, T]`` or ``[B, C, 1, T]``, ``alpha`` ``C`` values (DAC keeps ``[1, C,
    1]``), ``bias [C]`` -> ``(y, s or None)``; ``frames``: ``y``'s frames,
    zero past ``T``."""
    shape = (1, -1) + (1,) * (h.dim() - 2)
    s = h.float()
    if bias is not None:
        s = s + bias.float().view(shape)
    if residual is not None:
        s = s + residual.float()
    a = alpha.float().reshape(shape)
    y = s + (a + ALPHA_EPS).reciprocal() * torch.sin(a * s).pow(2)
    if frames is not None and frames > h.shape[-1]:
        y = F.pad(y, (0, frames - h.shape[-1]))
    return y.to(h.dtype), (s.to(h.dtype) if keep_sum else None)


def _frames_major(t: torch.Tensor, B: int, C: int, T: int) -> bool:
    """Whether ``t [B, C, 1, T]`` keeps each frame's channels contiguous, frames ``C`` apart."""
    return tuple(t.shape) == (B, C, 1, T) and t.stride(1) == 1 and (T == 1 or t.stride(3) == C)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def snake(h: torch.Tensor, alpha: torch.Tensor, bias: Optional[torch.Tensor] = None,
          residual: Optional[torch.Tensor] = None, keep_sum: bool = False,
          frames: Optional[int] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`snake_plain`'s result; one kernel launch for CUDA tensors."""
    if not h.is_cuda:
        return snake_plain(h, alpha, bias, residual, keep_sum, frames)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (h, alpha, bias, residual)):
        raise RuntimeError("snake: the kernel has no backward; run snake_plain where autograd records")
    if h.dtype not in DTYPE_CODES:
        raise ValueError(f"snake: bf16, f16 or f32 activations, not {h.dtype}")
    if residual is not None and (residual.shape != h.shape or residual.dtype != h.dtype):
        raise ValueError(f"snake: residual {tuple(residual.shape)} {residual.dtype} against {tuple(h.shape)} {h.dtype}")
    B, C, T = h.shape[0], h.shape[1], h.shape[-1]
    Ty = T if frames is None else int(frames)
    cl = h.dim() == 4
    if cl:
        if not all(_frames_major(t, B, C, T) for t in (h, residual) if t is not None):
            raise ValueError("snake: a [B, C, 1, T] input keeps each frame's channels contiguous (channels-last)")
        y = torch.empty((B, C, 1, Ty), dtype=h.dtype, device=h.device, memory_format=torch.channels_last)
        s = torch.empty((B, C, 1, T), dtype=h.dtype, device=h.device,
                        memory_format=torch.channels_last) if keep_sum else None
    else:
        if h.dim() != 3 or Ty != T:
            raise ValueError(f"snake: [B, C, T] or [B, C, 1, T], not {tuple(h.shape)} (frames {frames})")
        h = h.contiguous()
        residual = None if residual is None else residual.contiguous()
        y = torch.empty_like(h)
        s = torch.empty_like(h) if keep_sum else None
    alpha = alpha.reshape(C).float().contiguous()
    bias = None if bias is None else bias.reshape(C).float().contiguous()
    if alpha.device != h.device or (bias is not None and bias.device != h.device):
        raise ValueError("snake: alpha and bias on another device than the activations")
    v = VECTOR_BYTES // h.element_size()
    tensors = [t for t in (h, residual, y, s) if t is not None]
    vec = (C % v == 0 if cl else T % v == 0) and all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors) and (
        not cl or all(t.stride(0) % v == 0 for t in tensors))
    if cl and C // (v if vec else 1) > MAX_CHANNEL_VECTORS:
        raise ValueError(f"snake: {C} channels exceed the kernel's {MAX_CHANNEL_VECTORS} channel vectors")
    if h.numel() == 0:
        return y.zero_(), s
    ll = ctypes.c_longlong
    rc = load_library().acad_snake(
        h.data_ptr(), _ptr(residual), _ptr(bias), alpha.data_ptr(), y.data_ptr(), _ptr(s), B, C, T, Ty,
        ll(h.stride(0)), ll(residual.stride(0) if residual is not None else 0), ll(y.stride(0)),
        ll(s.stride(0) if s is not None else 0), int(cl), DTYPE_CODES[h.dtype], int(vec),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    check(rc, "snake")
    profiling.count("snake.launches")
    return y, s
