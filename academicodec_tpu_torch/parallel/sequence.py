"""Time-sharded (sequence-parallel) serving: one long stream over several devices.

The port's counterpart of academicodec_tpu/parallel/sequence.py
(``shard_time``, ``TimeShardedSoundStream``, ``TimeShardedVQVAE``). JAX
shards the time axis over a mesh and lets GSPMD insert the halo exchanges,
gathers and all-reduces. The port does that itself, in one process over a
device list (``parallel/mesh.serving_devices``); a list may name one device
several times, and then that many shards run on it. The rule is JAX's
(sequence.py:16-22): spatial partitioning moves data, not math. Every
output sample and token is computed from the same window as in the
unsharded run:

* :func:`time_blocks` cuts a stream into contiguous blocks of whole latent
  frames, so every shard boundary is a multiple of the model's hop and every
  strided conv's windows stay aligned; a stream of fewer frames than shards
  is served unsharded on the first device (JAX ``shard_time``'s fallback);
* :func:`halo_exchange` gives each shard any range of global time steps on
  its own device, copied from the shards that hold them
  (``Tensor.to(device, non_blocking=True)``); steps before 0 or past the end
  take the layer's own padding of the whole sequence (zeros, or reflect with
  ``ops/padding.pad1d``'s guard), so only the first and the last shard see
  it, and the extra right padding of a strided conv follows the global
  length (``ops/padding.get_extra_padding_for_conv1d``);
* strided convs and conv-transposes (:func:`conv`, :func:`conv_padded`,
  :func:`conv_transpose`) fetch the input window of their own output frames
  and call the layer as the unsharded forward calls it: an ``SConv1d``'s
  conv on the padded window, a HiFi-GAN ``Conv1d`` / ``ConvTranspose1d``
  with its own padding on a window aligned to the stride (on the card a conv
  called alike gives the same bits); same-length stacks (the HiFi-GAN resblock
  towers) run on their shard plus a halo of the stack's receptive field
  (:func:`with_halo`) and keep their own frames: the zero padding at the
  edges of the halo'd tensor spoils only frames inside the halo;
* the SLSTM, sequential in time, runs once on the frame-rate input gathered
  to the first device (one K2 launch on the card, bit for bit the unsharded
  call) and its output is scattered back;
* the RVQ (K1) and GRVQ searches and lookups are per frame: each shard
  quantizes its own frames;
* the HiFi-Codec encoder's GroupNorm statistics span the time axis: each
  frame is counted by one shard only (K4's tiles, each owned by the shard it
  starts in; on the wider stages each block's own valid frames, the layout
  :class:`TimeBlocks` that ``GroupNormTorch`` reads), the shards' sums meet
  on the first device, the affines follow from them and the global frame
  count, and each shard applies them to its own frames (the algebra of
  JAX's pass 2, academicodec_tpu/ops/pallas/resblock.py:583-631). K4's sums
  keep the tile order of one launch over the whole sequence
  (:func:`_encoder_stage_gn_fused`), so on the card they are its bits; the
  wider stages' sums (in ``GroupNormTorch``'s dtype: f64 for f32 on the
  card) and the CPU's plain sums are the one place where the sharded run
  adds in another order than the unsharded one.

Outputs are :class:`TimeShards`: the blocks, each on its device, in time
order; ``gather()`` (or ``np.asarray``) concatenates them.

Serving only: the sharded forwards run under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from academicodec_tpu_torch.nn.conv import ConvTranspose1d, Conv1d, SConv1d, SConvTranspose1d
from academicodec_tpu_torch.nn.hifigan import Frames, lrelu, norm_chain, strided_length
from academicodec_tpu_torch.nn.lstm import SLSTM
from academicodec_tpu_torch.nn.seanet import SEANetResnetBlock
from academicodec_tpu_torch.ops.padding import get_extra_padding_for_conv1d
from academicodec_tpu_torch.ops.cuda.resblock import (
    frame_mask,
    gn_tile,
    gn_tower_affines,
    gn_tower_apply,
    gn_tower_partials,
    moments_reduce,
    resblock_tower,
    tower_halo,
)
from academicodec_tpu_torch.parallel.mesh import module_replicas

Devices = Sequence[Union[str, torch.device]]


class TimeShards:
    """A tensor cut along its time axis ``dim`` into contiguous blocks, block
    ``i`` on its own device, in time order."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int = -1):
        if not parts:
            raise ValueError("TimeShards needs at least one block")
        self.parts = list(parts)
        self.dim = dim % parts[0].dim()

    @property
    def spans(self) -> List[Tuple[int, int]]:
        """Each block's ``[start, stop)`` in global time steps."""
        out, a = [], 0
        for p in self.parts:
            out.append((a, a + p.shape[self.dim]))
            a += p.shape[self.dim]
        return out

    @property
    def length(self) -> int:
        return sum(p.shape[self.dim] for p in self.parts)

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self.parts[0].shape)
        s[self.dim] = self.length
        return tuple(s)

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor], dim: Optional[int] = None) -> "TimeShards":
        """``fn`` on every block (pointwise in time); ``dim``: the results' time
        axis, if not this one."""
        return TimeShards([fn(p) for p in self.parts], self.dim if dim is None else dim)

    def __add__(self, other: "TimeShards") -> "TimeShards":
        return TimeShards([a + b for a, b in zip(self.parts, other.parts)], self.dim)

    def __truediv__(self, d) -> "TimeShards":
        return self.map(lambda p: p / d)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first block's by default)."""
        device = self.parts[0].device if device is None else torch.device(device)
        return torch.cat([p.to(device, non_blocking=True) for p in self.parts], dim=self.dim)

    def numpy(self) -> np.ndarray:
        t = self.gather("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def time_blocks(frames: int, n: int) -> Optional[List[Tuple[int, int]]]:
    """``n`` contiguous blocks ``[start, stop)`` of whole frames covering ``frames``
    frames, as equal as can be (the first ``frames % n`` one frame longer); None
    when there are fewer frames than blocks (the stream is then served
    unsharded)."""
    if n < 1:
        raise ValueError(f"time_blocks: {n} blocks")
    if frames < n:
        return None
    base, extra = divmod(frames, n)
    out, a = [], 0
    for i in range(n):
        b = a + base + (i < extra)
        out.append((a, b))
        a = b
    return out


def split_time(x: torch.Tensor, spans: Sequence[Tuple[int, int]], devices: Devices, dim: int = -1) -> TimeShards:
    """``x``'s time steps ``spans[i]`` (along ``dim``) on ``devices[i]``."""
    return TimeShards([x.narrow(dim, a, b - a).to(dev, non_blocking=True) for (a, b), dev in zip(spans, devices)],
                      dim)


def _take(x: TimeShards, lo: int, hi: int, device) -> torch.Tensor:
    """Global time steps ``[lo, hi)`` (inside ``[0, T)``) of ``x`` on ``device``:
    the pieces of every block that holds some, copied there and joined."""
    pieces = []
    for p, (a, b) in zip(x.parts, x.spans):
        s, e = max(lo, a), min(hi, b)
        if s < e:
            pieces.append(p.narrow(x.dim, s - a, e - s).to(device, non_blocking=True))
    if not pieces:
        shape = list(x.parts[0].shape)
        shape[x.dim] = 0
        return x.parts[0].new_zeros(shape).to(device)
    return (torch.cat(pieces, dim=x.dim) if len(pieces) > 1 else pieces[0]).contiguous()


def _outside(x: TimeShards, positions: Sequence[int], device, mode: str, pads: Tuple[int, int]) -> torch.Tensor:
    """Time steps at ``positions`` (before 0 or past the end) of the globally
    padded sequence ``pad1d(x, pads, mode)`` on ``device``."""
    shape = list(x.parts[0].shape)
    shape[x.dim] = len(positions)
    out = torch.zeros(shape, dtype=x.parts[0].dtype, device=device)
    if mode in ("zero", "constant") or not positions:
        return out
    if mode != "reflect":
        raise ValueError(f"time sharding: no halo exchange for padding mode {mode!r}")
    T = x.length
    # pad1d's guard: a sequence no longer than its largest pad is zero-extended first
    L = T + max(0, max(pads) - T + 1)
    src = [-i if i < 0 else 2 * (L - 1) - i for i in positions]
    keep = [j for j, s in enumerate(src) if 0 <= s < T]
    if keep:
        lo = min(src[j] for j in keep)
        vals = _take(x, lo, max(src[j] for j in keep) + 1, device)
        idx = torch.tensor([src[j] - lo for j in keep], device=device)
        out.index_copy_(x.dim, torch.tensor(keep, device=device), vals.index_select(x.dim, idx))
    return out


def halo_exchange(x: TimeShards, ranges: Sequence[Tuple[int, int]], mode: str = "zero",
                  pads: Tuple[int, int] = (0, 0)) -> List[torch.Tensor]:
    """For each block ``i``, the global time steps ``ranges[i] = [lo, hi)`` on
    block ``i``'s device: steps inside ``[0, T)`` copied from the blocks that
    hold them, steps outside as ``pad1d(whole sequence, pads, mode)`` gives them
    (``mode`` ``zero`` or ``reflect``; ``pads`` the sequence's left and right pad,
    which ``ranges`` must not exceed)."""
    T = x.length
    out = []
    for (lo, hi), dev in zip(ranges, x.devices):
        if lo < -pads[0] or hi > T + pads[1] or lo > hi:
            raise ValueError(f"halo_exchange: range [{lo}, {hi}) outside the padded sequence "
                             f"[{-pads[0]}, {T + pads[1]})")
        left = _outside(x, list(range(lo, min(hi, 0))), dev, mode, pads)
        mid = _take(x, max(lo, 0), min(hi, T), dev)
        right = _outside(x, list(range(max(lo, T), hi)), dev, mode, pads)
        out.append(torch.cat([left, mid, right], dim=x.dim) if left.shape[x.dim] or right.shape[x.dim] else mid)
    return out


def _own_outputs(x: TimeShards, stride: int, out_len: int) -> List[Tuple[int, int]]:
    """Each block's output frames ``[a / stride, b / stride)`` of a stride-``stride``
    layer with ``out_len`` outputs, the last block's up to ``out_len``; every
    block but the last starts and ends on a multiple of ``stride``."""
    n, out = len(x.parts), []
    for i, (a, b) in enumerate(x.spans):
        if a % stride or (i < n - 1 and b % stride):
            raise ValueError(f"time sharding: block [{a}, {b}) is not aligned to the stride {stride}")
        A, B = a // stride, (out_len if i == n - 1 else b // stride)
        if B <= A:
            raise ValueError(f"time sharding: block [{a}, {b}) has no output frame of a stride-{stride} conv")
        out.append((A, B))
    return out


def conv(x: TimeShards, fns: Sequence[Callable], k: int, stride: int = 1, dilation: int = 1,
         pads: Tuple[int, int] = (0, 0), mode: str = "zero") -> TimeShards:
    """A conv (kernel ``k``, ``stride``, ``dilation``) over the whole sequence
    padded by ``pads`` (``mode``), one block at a time, as ``SConv1d`` pads and
    then convolves: block ``i`` gets the padded window of its own output
    frames and ``fns[i]`` convolves it without padding."""
    pl, pr = pads
    out_len = (x.length + pl + pr - dilation * (k - 1) - 1) // stride + 1
    ranges = [(A * stride - pl, (B - 1) * stride - pl + dilation * (k - 1) + 1)
              for A, B in _own_outputs(x, stride, out_len)]
    return TimeShards([fn(e) for fn, e in zip(fns, halo_exchange(x, ranges, mode, pads))], x.dim)


def conv_padded(x: TimeShards, fns: Sequence[Callable], k: int, stride: int, dilation: int,
                padding: int) -> TimeShards:
    """A conv that zero-pads ``padding`` steps a side itself (``nn/conv.Conv1d``),
    one block at a time, each ``fns[i]`` called with that padding as over the
    whole sequence: block ``i`` gets a window that starts on a multiple of
    ``stride`` (so its outputs fall on the sequence's grid) and reaches far
    enough past its own output frames that the window's zero padding, where it
    is not the sequence's own, moves only outputs that are dropped."""
    T = x.length
    out_len = (T + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    m = -(-padding // stride)
    ranges, own = [], _own_outputs(x, stride, out_len)
    for A, B in own:
        ranges.append((max(0, (A - m) * stride), min(T, B * stride + dilation * (k - 1))))
    parts = [fn(e).narrow(x.dim, A - lo // stride, B - A)
             for fn, e, (lo, _), (A, B) in zip(fns, halo_exchange(x, ranges), ranges, own)]
    return TimeShards(parts, x.dim)


def conv_transpose(x: TimeShards, fns: Sequence[Callable], k: int, stride: int, crop: Tuple[int, int],
                   padded: bool = False) -> TimeShards:
    """A conv-transpose (kernel ``k >= stride``) over the whole sequence with
    ``crop`` outputs cut from its ends, one block at a time: block ``i`` owns
    outputs ``[stride a, stride b)`` of its input block ``[a, b)`` (the last up
    to the global length) and gets the inputs that reach them (none past the
    sequence's ends). ``fns[i]`` runs the conv-transpose with its bias and no
    crop (``SConvTranspose1d`` crops after the conv), or with ``padded`` the
    symmetric crop itself (``nn/conv.ConvTranspose1d``'s ``padding``)."""
    if k < stride:
        raise ValueError(f"time sharding: a conv-transpose with k {k} < stride {stride}")
    T, n = x.length, len(x.parts)
    pl, pr = crop
    if padded and pl != pr:
        raise ValueError(f"time sharding: a padded conv-transpose crops alike a side, got {crop}")
    out_len = (T - 1) * stride + k - pl - pr
    ranges, cuts = [], []
    for i, (a, b) in enumerate(x.spans):
        A, B = a * stride, (out_len if i == n - 1 else b * stride)
        j_lo, j_hi = max(0, (A + pl - k + 1) // stride), min(T, (B - 1 + pl) // stride + 1)
        ranges.append((j_lo, j_hi))
        cuts.append((A - j_lo * stride + (0 if padded else pl), B - A))
    parts = [fn(e).narrow(x.dim, off, m) for fn, e, (off, m) in zip(fns, halo_exchange(x, ranges), cuts)]
    return TimeShards(parts, x.dim)


def with_halo(x: TimeShards, halo: int) -> Tuple[List[torch.Tensor], List[int]]:
    """Each block with up to ``halo`` neighbouring steps a side (none past the
    sequence's ends) on its device, and where its own steps start in it."""
    T = x.length
    ranges = [(max(0, a - halo), min(T, b + halo)) for a, b in x.spans]
    return halo_exchange(x, ranges), [a - lo for (a, _), (lo, _) in zip(x.spans, ranges)]


def halo_map(x: TimeShards, halo: int, fns: Sequence[Callable]) -> TimeShards:
    """A same-length stack whose receptive field reaches ``halo`` steps a side and
    whose convs zero-pad at the sequence's ends: ``fns[i]`` on block ``i`` plus
    its halo, its own steps kept."""
    ext, offs = with_halo(x, halo)
    return TimeShards([fn(e).narrow(x.dim, off, b - a) for fn, e, off, (a, b) in zip(fns, ext, offs, x.spans)],
                      x.dim)


def gather_apply(x: TimeShards, fn: Callable) -> TimeShards:
    """``fn`` on the whole sequence gathered to the first block's device, its
    output scattered back to the blocks (for a recurrence over time)."""
    y = fn(x.gather())
    return split_time(y, x.spans, x.devices, x.dim)


# ---------------------------------------------------------------- layers


def _ksize(m: nn.Module) -> int:
    """The kernel size of a ``Conv1d`` / ``ConvTranspose1d``."""
    return (m.weight_v if m.norm == "weight_norm" else m.weight).shape[-1]


def sconv1d(ms: Sequence[SConv1d], x: TimeShards) -> TimeShards:
    """``SConv1d.forward`` over the sharded sequence: its padding, the extra right
    padding included, from the global length."""
    m = ms[0]
    k, s, d = m.kernel_size, m.stride, m.dilation
    total = (k - 1) * d - (s - 1)
    extra = get_extra_padding_for_conv1d(x.length, k, s, total)
    pads = (total, extra) if m.causal else (total - total // 2, total // 2 + extra)
    return conv(x, [mi.conv for mi in ms], k, s, d, pads, m.pad_mode)


def conv1d(ms: Sequence[Conv1d], x: TimeShards) -> TimeShards:
    """A HiFi-GAN ``Conv1d``, called with its own symmetric zero padding."""
    m = ms[0]
    return conv_padded(x, ms, _ksize(m), m.stride, m.dilation, m.padding)


def sconv_transpose1d(ms: Sequence[SConvTranspose1d], x: TimeShards) -> TimeShards:
    m = ms[0]
    total = m.kernel_size - m.stride
    right = math.ceil(total * m.trim_right_ratio) if m.causal else total // 2
    return conv_transpose(x, [mi.convtr for mi in ms], m.kernel_size, m.stride, (total - right, right))


def conv_transpose1d(ms: Sequence[ConvTranspose1d], x: TimeShards) -> TimeShards:
    """A HiFi-GAN ``ConvTranspose1d``, called with its own crop (``padding``)."""
    m = ms[0]
    return conv_transpose(x, ms, _ksize(m), m.stride, (m.padding, m.padding), padded=True)


def layer(ms: Sequence[nn.Module], x: TimeShards) -> TimeShards:
    """One layer of a SEANet tower (or a HiFi-GAN conv) over the sharded
    sequence; ``ms[i]`` is the layer's copy on block ``i``'s device."""
    m = ms[0]
    if isinstance(m, SConv1d):
        return sconv1d(ms, x)
    if isinstance(m, SConvTranspose1d):
        return sconv_transpose1d(ms, x)
    if isinstance(m, Conv1d):
        return conv1d(ms, x)
    if isinstance(m, ConvTranspose1d):
        return conv_transpose1d(ms, x)
    if isinstance(m, SLSTM):
        return gather_apply(x, m)
    if isinstance(m, SEANetResnetBlock):
        y = x
        for j in range(len(m.block)):
            y = layer([mi.block[j] for mi in ms], y)
        return layer([mi.shortcut for mi in ms], x) + y
    if isinstance(m, (nn.ELU, nn.Identity)):
        return TimeShards([mi(p) for mi, p in zip(ms, x.parts)], x.dim)
    raise TypeError(f"time sharding: no sharded forward for {type(m).__name__}")


def sequential(ms: Sequence[nn.Sequential], x: TimeShards) -> TimeShards:
    for j in range(len(ms[0])):
        x = layer([mi[j] for mi in ms], x)
    return x


class TimeBlocks(Frames):
    """The layout of a :class:`TimeShards` batch ``[B, C, t_i]``: each block's own
    frames below the global valid lengths ``L [B]`` (None: all), the blocks' sums
    added on the first device in block order, over the global count."""

    def __init__(self, x: TimeShards, L=None):
        self.dev0, self.length, self.count = x.parts[0].device, x.length, L
        self.mask = None if L is None else [frame_mask(L.to(p.device) - a, p.shape[2]).to(p.dtype)
                                            for p, (a, _) in zip(x.parts, x.spans)]

    def parts(self, x):
        return x.parts

    def join(self, ys, x):
        return TimeShards(ys, x.dim)

    def masked(self, x):
        return x if self.mask is None else TimeShards([p * m for p, m in zip(x.parts, self.mask)], x.dim)

    def spread(self, s, v):
        return s.to(v.device)

    def average(self, vs, acc):
        """``[v [B, G, C / G, t_i]]`` -> ``[B, G, 1, 1]``, summed in ``acc`` (by
        default f32, as ``Tensor.mean`` sums)."""
        acc = acc or torch.float32
        s = None
        for v, m in zip(vs, self.mask or [None] * len(vs)):
            v = v.to(acc)
            v = (v if m is None else v * m.to(acc)[:, None]).sum(dim=(2, 3), keepdim=True).to(self.dev0)
            s = v if s is None else s + v
        n = float(self.length) if self.count is None else self.count.to(self.dev0).to(acc).reshape(-1, 1, 1, 1)
        return s / (n * vs[0].shape[2])


# ---------------------------------------------------------------- models


def _replicas(model: nn.Module, devices: Devices) -> Tuple[List[torch.device], List[nn.Module]]:
    """The devices, and for each the model's copy on it: one copy a distinct
    device (a device named several times runs that many blocks on one copy)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("time sharding needs at least one device")
    distinct = list(dict.fromkeys(devices))
    copies = dict(zip(distinct, module_replicas(model, distinct)))
    return devices, [copies[d] for d in devices]


def _split_codes(codes, dim: int, devices: Sequence[torch.device]) -> Union[TimeShards, torch.Tensor]:
    """Codes (time on ``dim``) as one block a device: sharded codes with one
    block a device move block by block, others are cut by :func:`time_blocks`;
    codes too few to cut come back whole."""
    if isinstance(codes, TimeShards) and len(codes.parts) == len(devices):
        return TimeShards([p.to(d, non_blocking=True) for p, d in zip(codes.parts, devices)], codes.dim)
    codes = codes.gather() if isinstance(codes, TimeShards) else torch.as_tensor(codes)
    blocks = time_blocks(codes.shape[dim], len(devices))
    return codes if blocks is None else split_time(codes, blocks, devices, dim)


class TimeShardedSoundStream:
    """Time-sharded encode/decode of a SoundStream/Encodec model over ``devices``.

    ``encode(wav [B, T])`` cuts ``T`` into one block of whole frames per device
    and returns the codes ``[n_q, B, frames]`` as :class:`TimeShards`; ``decode``
    takes them sharded (or a whole ``[n, B, frames]`` tensor, which it cuts)
    and returns the wav ``[B, frames * hop]`` sharded. On the card every block
    runs K1, and the gathered SLSTMs K2 (JAX sequence.py:64-98)."""

    def __init__(self, model, devices: Devices, target_bw: Optional[float] = None):
        for m in model.modules():
            if getattr(m, "norm_type", None) == "time_group_norm":
                raise ValueError("time sharding: time_group_norm's statistics span the stream; "
                                 "no sharded forward for it")
        self.model = model
        self.devices, self.replicas = _replicas(model, devices)
        self.target_bw = target_bw if target_bw is not None else model.target_bandwidths[-1]

    @torch.no_grad()
    def encode(self, wav) -> TimeShards:
        m = self.model
        x = torch.as_tensor(wav).to(m.dtype)
        T = x.shape[-1]
        blocks = time_blocks(math.ceil(T / m.hop_length), len(self.devices))
        if blocks is None:
            return TimeShards([self.replicas[0].encode(x, target_bw=self.target_bw)])
        spans = [(a * m.hop_length, min(b * m.hop_length, T)) for a, b in blocks]
        e = sequential([r.encoder.model for r in self.replicas], split_time(x[:, None, :], spans, self.devices))
        return TimeShards([r.quantizer.encode(p.transpose(1, 2), r.frame_rate, self.target_bw)
                           for r, p in zip(self.replicas, e.parts)])

    @torch.no_grad()
    def decode(self, codes) -> TimeShards:
        c = _split_codes(codes, 2, self.devices)
        if isinstance(c, torch.Tensor):
            return TimeShards([self.replicas[0].decode(c)])
        q = TimeShards([r.quantizer.decode(p).transpose(1, 2) for r, p in zip(self.replicas, c.parts)])
        y = sequential([r.decoder.model for r in self.replicas], q)
        return y.map(lambda p: p[:, 0, :], dim=-1)

    def roundtrip(self, wav) -> Tuple[TimeShards, TimeShards]:
        codes = self.encode(wav)
        return codes, self.decode(codes)


def k4_shard_tiles(spans: Sequence[Tuple[int, int]], T: int, halo: int, TT: int):
    """K4 over time blocks ``spans`` of a ``T``-step sequence, its moments summed
    over tiles of ``TT`` steps, a tower reaching ``halo`` steps a side: each
    block owns the tiles ``[t_lo, t_hi)`` of the whole sequence that start in
    it (none for a block inside one tile) and runs pass 1 on the window
    ``[lo, hi)`` of the sequence, ``lo`` on a tile boundary, that covers its own
    steps and its tiles, each with the tower's halo. Returns the windows and
    the tiles."""
    halo_tiles = -(-halo // TT)
    ranges, tiles = [], []
    for a, b in spans:
        t_lo, t_hi = -(-a // TT), -(-b // TT)
        lo = TT * max(0, min((a - halo) // TT, t_lo - halo_tiles))
        ranges.append((lo, min(T, max(b + halo, (t_hi + halo_tiles) * TT))))
        tiles.append((t_lo, t_hi))
    return ranges, tiles


def _encoder_stage_gn_fused(encs, st: int, x: TimeShards, L) -> TimeShards:
    """An encoder stage narrow enough for K4.

    K4 sums its moments over tiles of ``TT`` time steps, then the tiles in
    order. Each block runs pass 1 on the window of :func:`k4_shard_tiles` and
    keeps the per-tile partials of the tiles it owns. Those of every block,
    gathered on the first device in the sequence's tile order and reduced
    there, are then the bits of one launch over the whole sequence on the
    card (each tile's rows are the same values summed in the same order). The
    affines follow from them and the global frame count; pass 2b runs on each
    block's own frames."""
    e0 = encs[0]
    packs = [e.packed_tower(st) for e in encs]
    TT = gn_tile(packs[0])
    ranges, tiles = k4_shard_tiles(x.spans, x.length, tower_halo(e0.rks, e0.rds, e0.config.resblock), TT)
    rs, parts = [], []
    for packed, p, (lo, _), (t_lo, t_hi), (a, b) in zip(packs, halo_exchange(x, ranges), ranges, tiles, x.spans):
        r, part = gn_tower_partials(p, packed, None if L is None else L - lo)
        rs.append(r.narrow(3, a - lo, b - a).contiguous())
        parts.append(part.narrow(1, t_lo - lo // TT, t_hi - t_lo))
    dev0 = x.parts[0].device
    mom = moments_reduce(torch.cat([p.to(dev0, non_blocking=True) for p in parts], dim=1))
    norms = e0.stage(st)[1]
    A, K = gn_tower_affines(mom, torch.stack([n.weight for n in norms]), torch.stack([n.bias for n in norms]),
                            norms[0].num_groups, norms[0].epsilon, x.length, L)
    return TimeShards([gn_tower_apply(r, A.to(r.device), K.to(r.device), None if L is None else L - a)
                       for r, (a, _) in zip(rs, x.spans)])


def _encoder_stage_unfused(encs, st: int, x: TimeShards, L) -> TimeShards:
    """A wider encoder stage: each chain on each block plus the tower's halo,
    then the chained GroupNorms with their statistics summed over the blocks."""
    e0 = encs[0]
    ext, offs = with_halo(x, tower_halo(e0.rks, e0.rds, e0.config.resblock))
    rs = [[] for _ in e0.rks]
    for e, p, off, (a, b) in zip(encs, ext, offs, x.spans):
        mask = None if L is None else frame_mask(L.to(p.device) - (a - off), p.shape[2]).to(p.dtype)
        for g, rb in enumerate(e.stage(st)[0]):
            rs[g].append(rb(p, mask).narrow(2, off, b - a))
    return norm_chain([TimeShards(r) for r in rs], e0.stage(st)[1], TimeBlocks(x, L))


def hifigan_encode(encs, x: TimeShards, lengths=None) -> TimeShards:
    """``HiFiGANEncoder.forward`` over the sharded ``[B, 1, T]`` wav; ``encs[i]`` is
    the encoder's copy on block ``i``'s device; ``lengths [B]``: each row's valid
    samples (the length-masked encode)."""
    e0 = encs[0]
    L = None if lengths is None else torch.as_tensor(lengths).reshape(-1).long().cpu()
    x = conv1d([e.conv_pre for e in encs], x)
    x = TimeBlocks(x, L).masked(x)
    for st, (u, k) in enumerate(e0.ups_cfg):
        x = conv1d([e.ups[st] for e in encs], x.map(lrelu))
        L = None if L is None else strided_length(L, k, u)
        x = TimeBlocks(x, L).masked(x)
        x = (_encoder_stage_gn_fused if e0.fused_stage(st) else _encoder_stage_unfused)(encs, st, x, L)
    return conv1d([e.conv_post for e in encs], x.map(lambda p: lrelu(p, 0.01)))


def _generator_stage_fused(gens, st: int, x: TimeShards, last: bool) -> TimeShards:
    """A generator stage narrow enough for K3, with
    conv_post and tanh fused into the last stage and, with ``fused_pre``, the
    lrelu and the upsampling conv-transpose in front (computed by K3 from the
    block's input window); each block carries a halo of the tower, the post
    conv and the prologue."""
    g0 = gens[0]
    h = g0.config
    post = [g.conv_post for g in gens] if last else [None] * len(gens)
    pre = [g.ups[st] for g in gens] if g0.fused_pre else [None] * len(gens)
    halo = tower_halo(h.resblock_kernel_sizes, h.resblock_dilation_sizes, h.resblock)
    halo += (_ksize(g0.conv_post) - 1) // 2 if last else 0
    if pre[0] is None:
        x = conv_transpose1d([g.ups[st] for g in gens], x.map(lrelu))
        u = 1
    else:
        u = pre[0].stride
        halo = -(-(halo + _ksize(pre[0])) // u)  # input steps whose upsampled window covers the tower's halo
    ext, offs = with_halo(x, halo)
    parts = []
    for g, p, off, (a, b), po, pr in zip(gens, ext, offs, x.spans, post, pre):
        parts.append(resblock_tower(p, g.packed_tower(st, po, pr), post_tanh=last).narrow(2, u * off, u * (b - a)))
    return TimeShards(parts)


def hifigan_generate(gens, x: TimeShards) -> TimeShards:
    """``HiFiGANGenerator.forward`` over the sharded latents ``[B, D, frames]``;
    ``gens[i]`` is the generator's copy on block ``i``'s device."""
    g0 = gens[0]
    h = g0.config
    halo = tower_halo(h.resblock_kernel_sizes, h.resblock_dilation_sizes, h.resblock)
    if h.causal:
        halo *= 2  # a causal chain reaches twice as far back, and not forward
    x = layer([g.conv_pre for g in gens], x)
    for st in range(len(g0.ups)):
        last = st == len(g0.ups) - 1
        if g0.fused_stage(st):
            x = _generator_stage_fused(gens, st, x, last)
            if last:
                return x
            continue
        x = layer([g.ups[st] for g in gens], x.map(lrelu))
        fns = [lambda p, blocks=g.stage(st): sum_blocks(blocks, p) for g in gens]
        x = halo_map(x, halo, fns)
    x = layer([g.conv_post for g in gens], x.map(lrelu))
    return x.map(torch.tanh)


def sum_blocks(blocks, x: torch.Tensor) -> torch.Tensor:
    """The mean of a stage's resblocks, summed in the generator's order."""
    xs = None
    for rb in blocks:
        r = rb(x)
        xs = r if xs is None else xs + r
    return xs / len(blocks)


class TimeShardedVQVAE:
    """Time-sharded encode/decode of a HiFi-Codec VQVAE over ``devices``.

    ``encode(wav [B, T], lengths=None)`` returns the tokens ``[B, frames,
    n_res * G]`` as :class:`TimeShards` (time on dim 1), ``lengths`` as
    ``VQVAE.encode``'s; ``decode`` takes them sharded (or whole) and returns
    the wav ``[B, frames * hop]`` sharded. On the card each block's encoder
    stages of at most 64 channels run K4, their GroupNorm moments summed over
    the blocks, and its generator stages of at most 64 channels K3 (JAX
    sequence.py:101-129)."""

    def __init__(self, model, devices: Devices):
        self.model = model
        self.devices, self.replicas = _replicas(model, devices)

    @torch.no_grad()
    def encode(self, wav, lengths=None) -> TimeShards:
        m = self.model
        x = torch.as_tensor(wav).to(m.dtype)
        T = x.shape[-1]
        blocks = time_blocks(m.frames_for(T), len(self.devices))
        if blocks is None:
            return TimeShards([self.replicas[0].encode(x, lengths)], dim=1)
        hop = m.hop_length
        spans = [(a * hop, b * hop) for a, b in blocks[:-1]] + [(blocks[-1][0] * hop, T)]
        c = hifigan_encode([r.encoder for r in self.replicas], split_time(x[:, None, :], spans, self.devices), lengths)
        return TimeShards([r.quantizer.encode(p.transpose(1, 2)) for r, p in zip(self.replicas, c.parts)], dim=1)

    @torch.no_grad()
    def decode(self, codes) -> TimeShards:
        c = _split_codes(codes, 1, self.devices)
        if isinstance(c, torch.Tensor):
            return TimeShards([self.replicas[0].decode(c)])
        q = TimeShards([r.quantizer.embed(p.long()).transpose(1, 2).contiguous()
                        for r, p in zip(self.replicas, c.parts)])
        return hifigan_generate([r.generator for r in self.replicas], q).map(lambda p: p[:, 0, :], dim=-1)
