"""The int8 decision probe's two conv chains: the hand-written CUDA kernels
(``csrc/chain.cu``) and their plain versions.

P1 :func:`conv_chain_bf16` replaces the TPU kernel
``benchmarks/pallas_int8_probe.py:_chain_kernel_bf16`` (``pallas_call`` at
:110), P2 :func:`conv_chain_i8` replaces ``_chain_kernel_i8`` (:116). Both
run a chain of ``P`` convs (the probe's 6) of k 7, dilation 1 and zero
"same" padding over ``x [C, T]`` or ``[B, C, T]`` bf16, every row its own
sequence, and return bf16 of ``x``'s shape. Conv ``p`` has weights ``W[p]
[C, 7C]`` in the probe's tap-major layout (column ``j C + ci`` is tap ``j`` of
input channel ``ci``, at offset ``j - 3``: :func:`shift_cols`) and bias ``b[p]
[C, 1]`` f32. P1 sums bf16 products in f32, adds the bias, applies
``where(y >= 0, y, 0.1 y)`` in f32 and rounds to bf16. P2 first quantizes
that bf16 value with the conv's static scale ``s_act[p]``
(``clip(round(x / s), -127, 127)``, IEEE division, half to even), sums int8 x
int8 products in int32, then dequantizes, ``y = float(yi) * (s[p] *
ws[p, co]) + b`` with no fused multiply-add, before the same lrelu and
rounding. The sums are exact (at most 7 * 64 * 127^2 < 2^24), so P2's plain
version sums in f32 and the kernel matches it bit for bit. Every conv reads
zeros outside ``[0, T)``.

:func:`calibrate` is the probe's ``run_case`` calibration: ``s[p] =
max(amax_p, 1e-6) / 127`` from the inputs' max |.| at each conv of the f32
reference chain (:func:`ref_chain`, f32 weights, each output rounded to
bf16), and per output channel ``ws = max(max |w|, 1e-12) / 127``, ``wq =
clip(round(w / ws), -127, 127)``. (``ops/int8.act_scale_from_amax`` has an
eps of 1e-12; the probe's 1e-6 is kept here.)

Weights carried across: the probe's parameters are plain arrays in the same
tap-major layout on both sides, so the tests feed the same numpy arrays to
the JAX kernel bodies and to these functions, and ``utils/convert.py`` has
nothing to convert. torch's ``[O, I, K]`` of the same convs is
:func:`to_oik`.

On the H100 both chains are bound by operations (see the source); the
kernels share one ``wgmma`` design (M = output channels, N = time over the
window's overlapping im2col view; :class:`ChainLayout` is its geometry) so
that their time ratio measures the number format; a short sequence takes the
narrow block (:func:`chain_cols`) so that its blocks fill more of the SMs. The wrappers take the
operands packed once by :func:`pack_chain_bf16` / :func:`pack_chain_i8` (the
A tiles of :func:`pack_taps_chain`, flat scales, and P2's quantizer
thresholds of :func:`quant_thresholds`, which replace a division per element
by one table load with the same bits; on the CPU only the arrays as given).
A CPU tensor runs the plain version; a CUDA tensor always launches the
kernel or raises: mixed devices, C other than 32 or 64, and a CUDA call that
autograd would record (the kernels have no backward) raise.
Each launch adds one to the counter ``p1.launches`` or
``p2.launches`` (``utils/profiling.py``); an empty ``x`` launches none.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from academicodec_tpu_torch.ops.cuda.build import check, load_library
from academicodec_tpu_torch.utils import profiling

KSIZE, HALF = 7, 3
LRELU_SLOPE = 0.1
# csrc/chain.cu: channel counts, convs a chain, wgmma's M rows, B columns a consumer
# warpgroup computes a conv (two halves of 128, or one in the narrow block), consumer
# warpgroups a block, a conv's first window row, entries of a P2 threshold table
CHAIN_CHANNELS = (32, 64)
MAX_CONVS, M_ROWS, N_COLS, CONSUMERS, FIRST_ROW, QTAB = 8, 64, 256, 2, 4, 256
N_HALF = N_COLS // 2
H100_SMS = 132  # the H100 SXM's SMs, for geometry computed off the card
QBIAS = 2.0 ** -13  # P2's quantizer takes its candidate this far below v / s
# the probe's calibration epsilons (benchmarks/pallas_int8_probe.py:96, :102)
ACT_EPS, WEIGHT_EPS = 1e-6, 1e-12


def shift_cols(a: torch.Tensor, k: int = KSIZE, d: int = 1) -> torch.Tensor:
    """The port's copy of the probe's ``_shift_cols``: ``[..., C, W] -> [...,
    k C, W]``, block ``j`` is ``a`` shifted by ``(j - (k - 1) / 2) d`` columns,
    zeros past either end."""
    W = a.shape[-1]
    c = (k - 1) // 2 * d
    ap = F.pad(a, (c, c))
    return torch.cat([ap[..., j * d:j * d + W] for j in range(k)], dim=-2)


def to_oik(w: torch.Tensor) -> torch.Tensor:
    """Tap-major ``[P, C, 7C]`` -> torch's ``[P, C_out, C_in, 7]`` (a view)."""
    P, C, _ = w.shape
    return w.view(P, C, KSIZE, C).permute(0, 1, 3, 2)


def _lrelu(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, y, LRELU_SLOPE * y)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[C, T]`` as one row ``[1, C, T]``; ``[B, C, T]`` as it is."""
    if x.dim() not in (2, 3):
        raise ValueError(f"conv chain: x must be [C, T] or [B, C, T], got {tuple(x.shape)}")
    return x[None] if x.dim() == 2 else x


def _col(v: torch.Tensor, P: int, C: int) -> torch.Tensor:
    """A per-conv, per-channel f32 vector as ``[P, C, 1]``."""
    return v.float().reshape(P, C, 1)


# ---------------------------------------------------------------- plain versions


def conv_chain_bf16_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P1 as the probe's kernel body writes it: ``W[p] @ shift_cols(cur)`` of
    bf16 values in f32, plus the bias, lrelu in f32, rounded to bf16."""
    cur = _rows(x).to(torch.bfloat16)
    P, C, _ = w.shape
    wf, bf = w.to(torch.bfloat16).float(), _col(b, P, C)
    for p in range(P):
        y = torch.matmul(wf[p], shift_cols(cur.float())) + bf[p]
        cur = _lrelu(y).to(torch.bfloat16)
    return cur.reshape(x.shape)


def quantize_act(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round(v / s), -127, 127)`` in f32 (integer values)."""
    return torch.round(v.float() / s).clamp(-127, 127)


def conv_chain_i8_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, b: torch.Tensor,
                        s_act: torch.Tensor) -> torch.Tensor:
    """P2 as the probe's kernel body writes it. The int8 sums are taken as an
    f32 matmul of integer values, exact (with TF32 on or off: an int8 value
    fits TF32's significand); the dequantizing multiply and the bias add are
    separate operations, as the kernel keeps them."""
    cur = _rows(x).to(torch.bfloat16)
    P, C, _ = wq.shape
    wf, wsf, bf, s = wq.float(), _col(ws, P, C), _col(b, P, C), s_act.float()
    for p in range(P):
        yi = torch.matmul(wf[p], shift_cols(quantize_act(cur, s[p])))
        y = yi * (s[p] * wsf[p])
        cur = _lrelu(y + bf[p]).to(torch.bfloat16)
    return cur.reshape(x.shape)


def ref_chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's ``ref_chain``: f32 weights, each conv's output rounded to
    bf16; returns it and ``amax [P]``, max |.| of each conv's input."""
    cur = _rows(x).to(torch.bfloat16)
    P, C, _ = w.shape
    wf, bf = w.float(), _col(b, P, C)
    amax = []
    for p in range(P):
        amax.append(cur.float().abs().max())
        y = torch.matmul(wf[p], shift_cols(cur.float())) + bf[p]
        cur = _lrelu(y).to(torch.bfloat16)
    return cur.reshape(x.shape), torch.stack(amax)


def act_scales(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-6) / 127`` in f32: the probe's static activation scales."""
    return amax.float().clamp_min(ACT_EPS) / 127.0


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per output channel of each conv: ``(wq [P, C, 7C] int8, ws [P, C, 1] f32)``."""
    wf = w.float()
    ws = wf.abs().amax(dim=2, keepdim=True).clamp_min(WEIGHT_EPS) / 127.0
    return torch.round(wf / ws).clamp(-127, 127).to(torch.int8), ws


def calibrate(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> dict:
    """The probe's calibration (``run_case``): the f32 reference output ``ref``,
    ``amax``, ``s_act [P]``, ``wq`` and ``ws``."""
    ref, amax = ref_chain(x, w, b)
    wq, ws = quantize_weights(w)
    return dict(ref=ref, amax=amax, s_act=act_scales(amax), wq=wq, ws=ws)


# ---------------------------------------------------------------- P2's exact quantizer


@functools.lru_cache(maxsize=None)
def _bf16_values(device: str) -> torch.Tensor:
    """Every bf16 value but NaN, as f32, in ascending order."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=device).to(torch.int16)
    v = bits.view(torch.bfloat16).float()
    return torch.sort(v[~torch.isnan(v)]).values


def quant_thresholds(s_act: torch.Tensor) -> torch.Tensor:
    """``[P]`` scales -> ``[P, 256]`` f32 thresholds, on ``s_act``'s device: entry
    ``q + 127`` is the least bf16 ``v`` with ``quantize_act(v, s) >= q`` for ``q``
    in -126 .. 127, found by :func:`quantize_act` itself over every bf16 value
    (monotone in ``v`` for ``s > 0``); the guards ``-inf`` (``q = -127``, every
    ``v``) and NaN (``q = 128``, none) close the ends."""
    s = s_act.detach().float().reshape(-1, 1)
    v = _bf16_values(str(s.device))
    q = quantize_act(v, s).contiguous()
    levels = torch.arange(-126, 128, dtype=torch.float32, device=s.device).expand(s.shape[0], -1).contiguous()
    tau = v[torch.searchsorted(q, levels)]
    ends = torch.full((s.shape[0], 1), float("-inf"), device=s.device)
    return torch.cat([ends, tau, torch.full_like(ends, float("nan"))], dim=1).contiguous()


def quantize_act_thresholds(v: torch.Tensor, s: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The kernel's quantizer, as its plain version: the candidate ``clip(rint(v
    (1/s) - 2^-13), -127, 127)`` lies at or one step below :func:`quantize_act`
    (``v / s`` and ``v (1/s)`` differ by a few ulp, less than the bias), and one
    threshold of ``tau [256]`` (:func:`quant_thresholds`) decides which. The
    candidate is the kernel's one fused multiply-add, ``fma(v, 1/s, -2^-13)``
    rounded once to f32: taken here in f64, where the product of a bf16 and an
    f32 is exact and so is the sum wherever its rounding can reach a
    half-integer. Equals :func:`quantize_act` for every bf16 value
    (``tests/test_torch_chain.py`` checks all of them)."""
    vf = v.float()
    inv = torch.reciprocal(s.float())
    q0 = torch.round((vf.double() * inv.double() - QBIAS).float()).clamp(-127, 127)
    return q0 + (vf >= tau[(q0 + 128).long()]).float()


# ---------------------------------------------------------------- the kernels' layout


@dataclass(frozen=True)
class ChainLayout:
    """What the launch and the packing need of the kernel's geometry for ``C``
    channels of ``itemsize`` bytes, ``P`` convs and ``cols`` B columns a consumer
    warpgroup (``Geo`` and ``out0`` in csrc/chain.cu; :func:`kernel_geometry`
    reads the rest, the ring's stages and the shared memory, from the library)."""

    C: int
    itemsize: int
    P: int
    cols: int = N_COLS

    @property
    def phases(self) -> int:
        """Output phases stacked in wgmma's M = 64 rows: one at C 64, two at C 32
        (rows ``(r, co)``, output time ``2u + r`` of B column ``u``)."""
        return M_ROWS // self.C

    @property
    def line(self) -> int:
        """Bytes between two B columns: the swizzle width of A and B."""
        return self.phases * self.C * self.itemsize

    @property
    def offsets(self) -> int:
        """Window rows in a column's K: the 7 taps, or 8 row offsets with two phases."""
        return KSIZE if self.phases == 1 else 8

    @property
    def tiles_per_conv(self) -> int:
        return self.offsets * self.C * self.itemsize // self.line

    @property
    def tile_bytes(self) -> int:
        return M_ROWS * self.line

    @property
    def span(self) -> int:
        """Window rows one consumer warpgroup computes a conv."""
        return self.phases * self.cols

    @property
    def rows(self) -> int:
        """Rows of a window (the block's two are ping-ponged between convs)."""
        return FIRST_ROW + CONSUMERS * self.span + HALF

    @property
    def out0(self) -> int:
        """The first output row of a tile: even, past the last conv's halo."""
        return (HALF * self.P + 2) & ~1

    @property
    def tile(self) -> int:
        """Output time steps a block: the widest multiple of 8 that the last
        conv's valid rows ``[3P + 1, rows - 3P)`` hold from ``out0``."""
        return (self.rows - HALF * self.P - self.out0) // 8 * 8

    def blocks(self, B: int, T: int) -> int:
        return B * -(-T // self.tile)


def chain_tile(P: int, C: int, cols: int = N_COLS) -> int:
    """Output time steps a block (``ChainLayout.tile``; the same for both
    chains)."""
    return ChainLayout(C, 2, P, cols).tile


def chain_cols(B: int, T: int, P: int, C: int, sms: int = H100_SMS) -> int:
    """B columns a consumer warpgroup computes a conv: the narrow block's 128
    where all of its ``B ceil(T / tile)`` blocks run at once on the ``sms`` SMs
    (one block an SM), else 256. A wide block's time is mostly its products,
    so on a short sequence the narrow one finishes in about half of it."""
    narrow = ChainLayout(C, 2, P, N_HALF).blocks(B, T)
    return N_HALF if narrow <= sms else N_COLS


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _launch_geometry(B: int, T: int, P: int, C: int, sms: int) -> Tuple[int, int]:
    """``(cols, TT)`` of a launch, kept per shape: a one-tile call takes tens of
    microseconds on the card, so the host's share of it counts."""
    cols = chain_cols(B, T, P, C, sms)
    return cols, chain_tile(P, C, cols)


def kernel_geometry(int8: bool, C: int, cols: int) -> dict:
    """The block geometry of a launch as the built library has it
    (``acad_conv_chain_geometry``): the window's rows, the ring's stages and the
    dynamic shared memory the launch sets."""
    out = (ctypes.c_int * 3)()
    check(load_library().acad_conv_chain_geometry(int(int8), C, cols, out), "conv chain geometry")
    return dict(rows=out[0], stages=out[1], smem_bytes=out[2])


def out_channel_perm(C: int) -> torch.Tensor:
    """P2's A rows: row ``m`` holds output channel ``perm[m]``; in each 16 rows, ``g ->
    2g`` and ``g + 8 -> 2g + 1``, so that a thread's accumulator rows ``g``, ``g +
    8`` are one int8 channel pair."""
    m = torch.arange(C)
    return 16 * (m // 16) + 2 * (m % 8) + (m % 16) // 8


def swizzle_perm(line: int, nbytes: int) -> torch.Tensor:
    """Byte permutation of a row-major ``[rows][line]`` tile under the wgmma
    swizzle of that width (16-byte chunks XORed with the 128-byte line index,
    ``line / 16 - 1`` masking it). An involution."""
    e = torch.arange(nbytes)
    return e ^ (((e >> 7) & (line // 16 - 1)) << 4)


def unswizzled_taps(w: torch.Tensor) -> torch.Tensor:
    """``[P, C, 7C]`` tap-major -> the kernel's A operand before the swizzle, ``[P,
    64, offsets, C]``: row ``r C + co`` holds output channel ``co`` (through
    :func:`out_channel_perm` for int8) of phase ``r`` at row offsets ``r .. r +
    6``; rows past the channels and the other offsets are 0."""
    P, C, _ = w.shape
    lay = ChainLayout(C, w.element_size(), P)
    taps = w.view(P, C, KSIZE, C)
    if w.dtype == torch.int8:
        taps = taps[:, out_channel_perm(C).to(w.device)]
    a = torch.zeros((P, M_ROWS, lay.offsets, C), dtype=w.dtype, device=w.device)
    for r in range(lay.phases):
        a[:, r * C:(r + 1) * C, r:r + KSIZE] = taps
    return a


def pack_taps_chain(w: torch.Tensor) -> torch.Tensor:
    """``[P, C, 7C]`` tap-major bf16 or int8 -> the kernel's A tiles, flat bytes:
    :func:`unswizzled_taps` cut along K into ``[64][line]`` tiles, conv after
    conv, each swizzled with its width's pattern (:func:`swizzle_perm`)."""
    P, C, _ = w.shape
    lay = ChainLayout(C, w.element_size(), P)
    a = unswizzled_taps(w)
    per = lay.line // w.element_size()
    tiles = a.reshape(P, M_ROWS, lay.tiles_per_conv, per).permute(0, 2, 1, 3).contiguous()
    raw = tiles.view(torch.uint8).reshape(P * lay.tiles_per_conv, lay.tile_bytes)
    return raw[:, swizzle_perm(lay.line, lay.tile_bytes).to(w.device)].reshape(-1)


@dataclass
class ChainOperands:
    """A chain's operands: ``raw`` as given (what the plain version reads:
    ``(w, b)`` for P1, ``(wq, ws, b, s_act)`` for P2) and, on the card, the
    kernel's: the A tiles of :func:`pack_taps_chain`, the f32 biases, weight
    scales and activation scales, flat, and P2's thresholds
    (:func:`quant_thresholds`). Build with
    :func:`pack_chain_bf16` / :func:`pack_chain_i8`."""

    int8: bool
    C: int
    P: int
    device: torch.device
    raw: Tuple[torch.Tensor, ...]
    tiles: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    ws: Optional[torch.Tensor] = None
    s_act: Optional[torch.Tensor] = None
    tau: Optional[torch.Tensor] = None


def _check_shapes(name: str, w: torch.Tensor, *vectors: Tuple[str, torch.Tensor, int]) -> Tuple[int, int]:
    if w.dim() != 3 or w.shape[2] != KSIZE * w.shape[1]:
        raise ValueError(f"{name}: weights must be [P, C, 7C], got {tuple(w.shape)}")
    P, C = w.shape[0], w.shape[1]
    for what, v, n in vectors:
        if v.numel() != n:
            raise ValueError(f"{name}: {what} of {tuple(v.shape)} for P={P}, C={C}")
    return P, C


def _same_device(name: str, tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; the chain takes one device")
    return devices.pop()


def _pack(name: str, int8: bool, raw: Tuple[torch.Tensor, ...], P: int, C: int) -> ChainOperands:
    dev = _same_device(name, raw)
    ops = ChainOperands(int8=int8, C=C, P=P, device=dev, raw=raw)
    if dev.type != "cuda":
        return ops
    if C not in CHAIN_CHANNELS or P > MAX_CONVS:
        raise ValueError(f"{name}: the kernel takes C in {CHAIN_CHANNELS} and at most {MAX_CONVS} convs; "
                         f"got C={C}, P={P}")
    w = raw[0]
    ops.tiles = pack_taps_chain(w if int8 else w.detach().to(torch.bfloat16)).contiguous()
    ops.bias = (raw[2] if int8 else raw[1]).detach().float().reshape(-1).contiguous()
    if int8:
        ops.ws = raw[1].detach().float().reshape(-1).contiguous()
        ops.s_act = raw[3].detach().float().reshape(-1).contiguous()
        ops.tau = quant_thresholds(ops.s_act)
    return ops


def pack_chain_bf16(w: torch.Tensor, b: torch.Tensor) -> ChainOperands:
    """P1's operands: ``w [P, C, 7C]`` (rounded to bf16), ``b [P, C, 1]``."""
    P, C = _check_shapes("conv_chain_bf16", w, ("bias", b, w.shape[0] * w.shape[1]))
    return _pack("conv_chain_bf16", False, (w, b), P, C)


def pack_chain_i8(wq: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, s_act: torch.Tensor) -> ChainOperands:
    """P2's operands: ``wq [P, C, 7C]`` int8, ``ws [P, C, 1]``, ``b [P, C, 1]``,
    ``s_act [P]`` f32, positive (kept on its device: the kernel reads it and its
    thresholds there)."""
    if wq.dtype != torch.int8:
        raise ValueError(f"conv_chain_i8: int8 weights, got {wq.dtype}")
    n = wq.shape[0] * wq.shape[1] if wq.dim() == 3 else -1
    P, C = _check_shapes("conv_chain_i8", wq, ("weight scales", ws, n), ("bias", b, n),
                         ("activation scales", s_act, wq.shape[0]))
    return _pack("conv_chain_i8", True, (wq, ws, b, s_act), P, C)


def _launch(name: str, x: torch.Tensor, ops: ChainOperands) -> torch.Tensor:
    """The CUDA call's checks, then one launch, counted."""
    if ops.device.type != "cuda" or x.device != ops.device:
        raise ValueError(f"{name}: x on {x.device}, operands on {ops.device}; the kernel takes CUDA tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ops.raw)):
        raise RuntimeError(f"{name}: the kernel has no backward, and autograd would record this call; "
                           "call it under torch.no_grad()")
    xr = _rows(x)
    if x.dtype != torch.bfloat16 or xr.shape[1] != ops.C:
        raise ValueError(f"{name}: x must be bf16 [., {ops.C}, T], got {x.dtype} {tuple(x.shape)}")
    xr = xr.contiguous()
    B, C, T = xr.shape
    y = torch.empty_like(xr)
    if B == 0 or T == 0:
        return y.reshape(x.shape)
    index = torch.cuda.current_device() if x.device.index is None else x.device.index
    cols, TT = _launch_geometry(B, T, ops.P, C, _sm_count(index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = load_library()
    if ops.int8:
        rc = lib.acad_conv_chain_i8(xr.data_ptr(), ops.tiles.data_ptr(), ops.ws.data_ptr(), ops.bias.data_ptr(),
                                    ops.s_act.data_ptr(), ops.tau.data_ptr(), y.data_ptr(), B, C, T, ops.P, TT,
                                    cols, stream)
    else:
        rc = lib.acad_conv_chain_bf16(xr.data_ptr(), ops.tiles.data_ptr(), ops.bias.data_ptr(), y.data_ptr(),
                                      B, C, T, ops.P, TT, cols, stream)
    check(rc, name)
    profiling.count("p2.launches" if ops.int8 else "p1.launches")
    return y.reshape(x.shape)


def conv_chain_bf16(x: torch.Tensor, ops: ChainOperands) -> torch.Tensor:
    """P1 over ``x [C, T]`` or ``[B, C, T]`` bf16 with the operands of
    :func:`pack_chain_bf16`."""
    if ops.int8:
        raise ValueError("conv_chain_bf16: operands packed for conv_chain_i8")
    if x.device.type == "cpu" and ops.device.type == "cpu":
        return conv_chain_bf16_plain(x, *ops.raw)
    return _launch("conv_chain_bf16", x, ops)


def conv_chain_i8(x: torch.Tensor, ops: ChainOperands) -> torch.Tensor:
    """P2 over ``x [C, T]`` or ``[B, C, T]`` bf16 with the operands of
    :func:`pack_chain_i8`."""
    if not ops.int8:
        raise ValueError("conv_chain_i8: operands packed for conv_chain_bf16")
    if x.device.type == "cpu" and ops.device.type == "cpu":
        return conv_chain_i8_plain(x, *ops.raw)
    return _launch("conv_chain_i8", x, ops)
