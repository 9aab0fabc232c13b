"""Fused 2-layer LSTM recurrence: the hand-written CUDA kernel (``csrc/lstm2.cu``)
and its plain version.

Replaces the TPU kernel ``academicodec_tpu/ops/pallas/lstm.py:_lstm2_kernel``
(``lstm2_fused``). Given the layer-1 input projection ``x_proj [T, B, 4H]``
(f32, biases included) it runs both layers (gate order i, f, g, o) with f32
carries and returns layer 2's hidden states ``y [T, B, H]``.

The weights' dtype picks the function, with no flag: bf16 weights give the
Pallas kernel's serving numerics (``h`` rounded to bf16 before each product,
f32 accumulation), f32 weights the f32 scan path of
``academicodec_tpu/nn/lstm.py``.

On the H100 the recurrent products are 50.3 GFLOP per flagship call
(T 1000, B 8, H 512), 0.051 ms at the bf16 tensor-core peak, but the real
limit is the chain of T dependent steps. The kernel runs one launch per
step, layer 2 one step behind layer 1, so each launch reads only hidden
states finished by the previous one; each block owns a slice of hidden
units with all four of their gate rows, so the cell update stays in the
block. h and c live in global memory (ping-ponged), and the ``T + 1``
launches are enqueued by a host loop inside the library, in one call.

``lstm2`` runs the kernel for CUDA tensors and the plain version only for
CPU tensors. ``LAUNCHES`` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

import torch

from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES, check, load_library

LAUNCHES = 0

_KERNEL_TYPES = {  # (weight dtype, output dtype) instantiated in csrc/lstm2.cu
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
}


def _lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm2_plain(
    x_proj: torch.Tensor,
    w_hh1: torch.Tensor,
    w_ih2: torch.Tensor,
    w_hh2: torch.Tensor,
    b2: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """The kernel's function step by step: ``h`` is rounded to the weights'
    dtype and back, then multiplied in f32, as the kernel does."""
    T, B, _ = x_proj.shape
    H = w_hh1.shape[1]
    wdt = w_hh1.dtype
    whh1, wih2, whh2 = (w.float().t() for w in (w_hh1, w_ih2, w_hh2))

    def mm(h, w):
        return torch.matmul(h.to(wdt).float(), w)

    b2 = b2.float()
    h1 = c1 = h2 = c2 = torch.zeros((B, H), dtype=torch.float32, device=x_proj.device)
    ys = []
    for t in range(T):
        h1, c1 = _lstm_cell(x_proj[t] + mm(h1, whh1), c1)
        h2, c2 = _lstm_cell(mm(h1, wih2) + mm(h2, whh2) + b2, c2)
        ys.append(h2)
    if not ys:
        return torch.empty((0, B, H), dtype=out_dtype, device=x_proj.device)
    return torch.stack(ys).to(out_dtype)


def lstm2(
    x_proj: torch.Tensor,
    w_hh1: torch.Tensor,
    w_ih2: torch.Tensor,
    w_hh2: torch.Tensor,
    b2: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Two stacked LSTM layers from the layer-1 projection ``x_proj [T, B, 4H]``
    f32; ``w_* [4H, H]`` (one dtype), ``b2 [4H]`` = layer 2's ``b_ih + b_hh``.
    Returns ``y [T, B, H]`` in ``out_dtype``."""
    tensors = (x_proj, w_hh1, w_ih2, w_hh2, b2)
    if all(t.device.type == "cpu" for t in tensors):
        return lstm2_plain(x_proj, w_hh1, w_ih2, w_hh2, b2, out_dtype)
    dev = x_proj.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"lstm2: tensors on {[str(t.device) for t in tensors]}")
    T, B, H4 = x_proj.shape
    H = w_hh1.shape[1]
    if H4 != 4 * H or any(w.shape != (4 * H, H) for w in (w_hh1, w_ih2, w_hh2)):
        raise ValueError(f"lstm2: x_proj {tuple(x_proj.shape)} vs weights {tuple(w_hh1.shape)}")
    if b2.shape != (4 * H,) or x_proj.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError("lstm2: x_proj and b2 must be f32 with b2 of shape [4H]")
    wdt = w_hh1.dtype
    if w_ih2.dtype != wdt or w_hh2.dtype != wdt or (wdt, out_dtype) not in _KERNEL_TYPES:
        raise ValueError(f"lstm2: no kernel for weights {wdt} and output {out_dtype}")
    if (2 * B * H + 3 * 4 * 4 * B) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"lstm2: B={B}, H={H} exceed the kernel's shared memory")
    x_proj, w_hh1, w_ih2, w_hh2, b2 = (t.contiguous() for t in tensors)
    y = torch.empty((T, B, H), dtype=out_dtype, device=dev)
    scratch = torch.empty((6, B, H), dtype=torch.float32, device=dev)  # h1 x2, h2 x2, c1, c2
    rc = load_library().acad_lstm2(
        x_proj.data_ptr(), w_hh1.data_ptr(), w_ih2.data_ptr(), w_hh2.data_ptr(),
        b2.data_ptr(), scratch.data_ptr(), y.data_ptr(), T, B, H,
        int(wdt == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(rc, "lstm2")
    global LAUNCHES
    LAUNCHES += 1
    return y
