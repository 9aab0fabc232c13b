"""Fused 2-layer LSTM recurrence: the hand-written CUDA kernel (``csrc/lstm2.cu``)
and its plain version.

Replaces the TPU kernel ``academicodec_tpu/ops/pallas/lstm.py:_lstm2_kernel``
(``lstm2_fused``). Given the layer-1 input projection ``x_proj [T, B, 4H]``
(f32, biases included) it runs both layers (gate order i, f, g, o) with f32
carries and returns layer 2's hidden states ``y [T, B, H]``. An optional
``carry = (h1, c1, h2, c2)``, each f32 ``[B, H]``, continues a stream, and
``return_carry=True`` also gives back the final four: one call over ``T``
steps equals, bitwise, calls over pieces of ``T`` that pass the carry along.

The weights' dtype picks the function, with no flag: bf16 weights give the
Pallas kernel's serving numerics (``h`` rounded to bf16 before each product,
f32 accumulation), f32 weights the f32 scan path of
``academicodec_tpu/nn/lstm.py``. The carries are f32 in both cases, where
the JAX scan path carries them in the model's dtype: in bf16 the port
differs from JAX by design, and parity with JAX is held in f32.

On the H100 the recurrent products are 50.3 GFLOP per flagship call
(T 1000, B 8, H 512), 0.051 ms at the bf16 tensor-core peak, but the real
limit is the chain of T dependent steps, each ending in an exchange of h
between the SMs. The kernel is one cooperative, persistent launch per call:
each block keeps its units' rows of the three weight matrices in shared
memory for the whole sequence (bf16 products on the tensor cores), layer 2
runs one step behind layer 1, and the blocks meet at one grid barrier per
step. :func:`lstm2_geometry` picks how many units a block owns so that all
blocks are resident at once, one per SM; a shape that does not fit raises.
A carry enters the kernel directly: each block loads its own units' state,
and one extra grid barrier publishes h before the first step.

``lstm2`` runs the kernel for CUDA tensors and the plain version only for
CPU tensors. ``LAUNCHES`` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from academicodec_tpu_torch.ops.cuda.build import MAX_SMEM_BYTES, check, load_library

LAUNCHES = 0

WARPS = 12  # warps per block of csrc/lstm2.cu

_KERNEL_TYPES = {  # (weight dtype, output dtype) instantiated in csrc/lstm2.cu
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
}


def lstm2_smem_bytes(jb: int, B: int, H: int, w_itemsize: int) -> int:
    """Shared memory of one block owning ``jb`` units (csrc/lstm2.cu ``Layout``):
    its weight rows (bf16 in fragment order, or f32 rows padded by 4), the
    warps' partial products, the prefetched ``x_proj`` slice, c1, c2 and b2."""
    rows, hp, bp = 4 * jb, -(-H // 16) * 16, -(-B // 8) * 8
    weights = 3 * rows * hp * 2 if w_itemsize == 2 else 3 * rows * (hp + 4) * 4
    return weights + 4 * (bp * (WARPS * rows + rows + 2 * jb) + rows)


def lstm2_geometry(B: int, H: int, w_itemsize: int, num_sms: int):
    """``(units per block, blocks, shared-memory bytes)`` of the persistent
    launch: the fewest units per block (a multiple of 4, so that a block's
    gate rows fill whole 16-row tiles) with at most one block per SM. Raises
    ``RuntimeError`` when no such block fits in shared memory."""
    for jb in range(4, -(-H // 4) * 4 + 1, 4):
        smem = lstm2_smem_bytes(jb, B, H, w_itemsize)
        if smem > MAX_SMEM_BYTES:
            break
        blocks = -(-H // jb)
        if blocks <= num_sms:
            return jb, blocks, smem
    raise RuntimeError(
        f"lstm2: B={B}, H={H}: the weight rows of {H} units do not fit in the shared memory "
        f"of {num_sms} blocks ({MAX_SMEM_BYTES} bytes each), so the recurrence cannot stay resident"
    )


def _lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def lstm2_plain(
    x_proj: torch.Tensor,
    w_hh1: torch.Tensor,
    w_ih2: torch.Tensor,
    w_hh2: torch.Tensor,
    b2: torch.Tensor,
    out_dtype: torch.dtype,
    carry: Optional[Carry] = None,
    return_carry: bool = False,
):
    """The kernel's function step by step: ``h`` is rounded to the weights'
    dtype and back, then multiplied in f32, as the kernel does."""
    T, B, _ = x_proj.shape
    H = w_hh1.shape[1]
    wdt = w_hh1.dtype
    whh1, wih2, whh2 = (w.float().t() for w in (w_hh1, w_ih2, w_hh2))

    def mm(h, w):
        return torch.matmul(h.to(wdt).float(), w)

    b2 = b2.float()
    if carry is None:
        h1 = c1 = h2 = c2 = torch.zeros((B, H), dtype=torch.float32, device=x_proj.device)
    else:
        h1, c1, h2, c2 = (t.float() for t in carry)
    ys = []
    for t in range(T):
        h1, c1 = _lstm_cell(x_proj[t] + mm(h1, whh1), c1)
        h2, c2 = _lstm_cell(mm(h1, wih2) + mm(h2, whh2) + b2, c2)
        ys.append(h2)
    if ys:
        y = torch.stack(ys).to(out_dtype)
    else:
        y = torch.empty((0, B, H), dtype=out_dtype, device=x_proj.device)
    return (y, (h1, c1, h2, c2)) if return_carry else y


def lstm2(
    x_proj: torch.Tensor,
    w_hh1: torch.Tensor,
    w_ih2: torch.Tensor,
    w_hh2: torch.Tensor,
    b2: torch.Tensor,
    out_dtype: torch.dtype,
    carry: Optional[Carry] = None,
    return_carry: bool = False,
):
    """Two stacked LSTM layers from the layer-1 projection ``x_proj [T, B, 4H]``
    f32; ``w_* [4H, H]`` (one dtype), ``b2 [4H]`` = layer 2's ``b_ih + b_hh``.
    ``carry = (h1, c1, h2, c2)``, each ``[B, H]`` (taken as f32), is the state
    before the first step, zeros when None. Returns ``y [T, B, H]`` in
    ``out_dtype``, and with ``return_carry`` ``(y, final carry)``, the
    carry's four f32 ``[B, H]``."""
    tensors = (x_proj, w_hh1, w_ih2, w_hh2, b2, *(carry or ()))
    if all(t.device.type == "cpu" for t in tensors):
        return lstm2_plain(x_proj, w_hh1, w_ih2, w_hh2, b2, out_dtype, carry, return_carry)
    dev = x_proj.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"lstm2: tensors on {[str(t.device) for t in tensors]}")
    T, B, H4 = x_proj.shape
    H = w_hh1.shape[1]
    if H4 != 4 * H or any(w.shape != (4 * H, H) for w in (w_hh1, w_ih2, w_hh2)):
        raise ValueError(f"lstm2: x_proj {tuple(x_proj.shape)} vs weights {tuple(w_hh1.shape)}")
    if b2.shape != (4 * H,) or x_proj.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError("lstm2: x_proj and b2 must be f32 with b2 of shape [4H]")
    if carry is not None and (len(carry) != 4 or any(t.shape != (B, H) for t in carry)):
        raise ValueError(f"lstm2: the carry must be four [B, H] = [{B}, {H}] tensors")
    wdt = w_hh1.dtype
    if w_ih2.dtype != wdt or w_hh2.dtype != wdt or (wdt, out_dtype) not in _KERNEL_TYPES:
        raise ValueError(f"lstm2: no kernel for weights {wdt} and output {out_dtype}")
    y = torch.empty((T, B, H), dtype=out_dtype, device=dev)
    if T == 0 or B == 0:
        if not return_carry:
            return y
        final = carry or (torch.zeros((B, H), device=dev),) * 4
        return y, tuple(t.float() for t in final)
    jb, blocks, smem = lstm2_geometry(B, H, w_hh1.element_size(), _num_sms(dev))
    if (T + 1) * blocks >= 2**32:
        raise ValueError(f"lstm2: T={T} overflows the 32-bit barrier counter of {blocks} blocks")
    x_proj, w_hh1, w_ih2, w_hh2, b2 = (t.contiguous() for t in tensors[:5])
    carry_in = None if carry is None else torch.stack(carry).float().contiguous()  # [4, B, H]
    carry_out = torch.empty((4, B, H), dtype=torch.float32, device=dev) if return_carry else None
    # one zeroed allocation: the h1 and h2 ping-pong buffers [4, B, H] in the
    # weights' dtype, padded to [4, 8k, 16k], then the barrier counter
    hbytes = 4 * (-(-B // 8) * 8) * (-(-H // 16) * 16) * w_hh1.element_size()
    scratch = torch.zeros((hbytes + 16,), dtype=torch.uint8, device=dev)
    rc = load_library().acad_lstm2(
        x_proj.data_ptr(), w_hh1.data_ptr(), w_ih2.data_ptr(), w_hh2.data_ptr(), b2.data_ptr(),
        None if carry_in is None else carry_in.data_ptr(),
        None if carry_out is None else carry_out.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + hbytes, y.data_ptr(), T, B, H,
        jb, blocks, smem, int(wdt == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(rc, "lstm2")
    global LAUNCHES
    LAUNCHES += 1
    return (y, tuple(carry_out.unbind(0))) if return_carry else y


def _num_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def grid_barriers(iters: int, B: int, H: int, w_dtype: torch.dtype, device) -> None:
    """Enqueue ``iters`` bare grid barriers on the grid ``lstm2`` would launch
    for this shape (same blocks, threads and shared memory) and nothing else:
    the floor of one recurrence step. For timing only; not counted in
    ``LAUNCHES``."""
    dev = torch.device(device)
    _, blocks, smem = lstm2_geometry(B, H, w_dtype.itemsize, _num_sms(dev))
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    rc = load_library().acad_grid_barrier(
        barrier.data_ptr(), iters, blocks, smem, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "grid_barriers")
