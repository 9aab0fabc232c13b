"""HiFi-GAN encoder and generator (the HiFi-Codec backbone) on ``[B, C, T]``.

Submodule names follow the reference module tree (``conv_pre``, ``ups.{i}``,
``resblocks.{i}.convs1.{j}``, ``normalize.{i}``, ``conv_post``), so the
reference ``g_*`` state dicts load with ``load_state_dict``.

Stages with at most ``FUSED_MAX_CHANNELS`` channels run their resblock towers
through ``ops/cuda/resblock``: the encoder's bundle through K4
(``resblock_tower_gn``), the generator's through K3 (``resblock_tower``,
with conv_post and tanh fused into the last stage and, with
``HiFiGANGenerator(fused_pre=True)``, the stage's lrelu and upsampling
conv-transpose fused in front). The wrappers launch the kernels for CUDA
tensors and run their plain versions for CPU tensors. Wider stages run the
plain chain of convs. Each fused stage keeps its packed operands
(:class:`PackedStage`) and rebuilds them, weight norm included, only when a
parameter changed.

K3/K4 have no backward. When autograd would record a narrow stage (gradients
enabled and its input or a parameter of its modules requiring one), the
stage runs its unfused ``ResBlock1/2`` (+ ``GroupNormTorch``) chain instead,
as the wider stages do and as the JAX trainer runs every stage; the
wrappers raise on a CUDA tensor that autograd would record. This is the
trainer's G phase; its no-grad forwards launch K3/K4.

``HiFiGANEncoder.forward(x, lengths)`` is the length-masked encode of the
JAX package (academicodec_tpu/nn/hifigan.py:318-344): ``lengths [B]`` marks
each row's valid prefix of a zero-padded batch, every conv output is zeroed
past it and the GroupNorm statistics count only valid frames, so that each
row's valid frames equal its exact-length encode. K4 takes the lengths
itself. Given host lengths (no autograd), each wider stage runs on its
valid frames only (:class:`Segments`): the rows' valid frames laid end to
end in one row ``[1, C, N]``, each followed by as many zero frames as the
stage's convs reach, the GroupNorm statistics taken per segment, and the
stage's output put back into the zero-padded batch. Each stage counts its
padded frames (``encoder.frames``) and the frames it computes
(``encoder.frames_computed``) in ``utils/profiling.py``.

``int8_min_channels`` (0 = off) serves the resblock convs of every stage of
at least that many channels that is not fused as W8A8 int8
(``Conv1d(w8a8=True)``, ``ops/int8.py``), after a calibration pass
(``models/hificodec.calibrate_quant``). Fused stages (at most
``FUSED_MAX_CHANNELS``) stay in K3/K4 at full precision, so the port's
threshold N serves what JAX's ``fused_resblock=True, int8_min_channels=N``
serves (JAX nn/hifigan.py:403-451, 670-684). The causal generator has no
int8 variant.

In 16-bit on the card, the stages wider than ``FUSED_MAX_CHANNELS`` run on a
channels-last ``[B, C, 1, T]`` activation (:func:`channels_last_stages`):
cuDNN's 16-bit convs are NHWC kernels, and on a ``[B, C, T]`` tensor each
conv reorders its input to channels-last and its output back. The encoder
enters the layout in the lrelu in front of its first wide stage's strided
conv and leaves it as a view after ``conv_post`` (its output ``[B, D, T]``
has each frame's channels contiguous, so ``c.transpose(1, 2)`` is ``[B, T,
D]`` with no copy); the generator takes the decode's ``[B, T, D]`` latents as
a ``[B, D, 1, T]`` view and hands its first fused stage a contiguous ``[B,
C, T]``. Every conv, lrelu, residual add and GroupNorm in between keeps the
layout. f32, length-masked encodes, int8 models and causal generators keep
``[B, C, T]``. The layout changes count ``towers.layout_copies`` and the
convs ``towers.cl_convs`` (``nn/conv.py``, ``utils/profiling.py``).

``HiFiCodecConfig(causal=True)`` builds the causal generator of the JAX
package: every conv left-padded with zeros (``SConv1d``), every upsample
conv-transpose right-trimmed (``SConvTranspose1d``), so that tokens -> wav
streams chunk by chunk (``HiFiGANGenerator.stream``). Causal stages run the
plain chain of convs at every width: the fused towers have no causal
variant, as in JAX (nn/hifigan.py:536). The encoder has no causal variant.

Behavioral parity target: academicodec_tpu/nn/hifigan.py:40-722
(reference models/hificodec/models.py: 18-189, 364-427, including the
GroupNorm of the accumulated sum at models.py:410-415).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.nn.conv import Conv1d, ConvTranspose1d, SConv1d, SConvTranspose1d
from academicodec_tpu_torch.ops.cuda.resblock import (
    PackedTower,
    frame_mask,
    on_host,
    pack_tower,
    resblock_tower,
    resblock_tower_gn,
)
from academicodec_tpu_torch.utils import profiling

LRELU_SLOPE = 0.1
# stages this narrow take the fused towers: the JAX package's default
# fused_max_channels (academicodec_tpu/nn/hifigan.py:307,510)
FUSED_MAX_CHANNELS = 64


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask is None else x * mask


def on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def channels_last_stages(x: torch.Tensor, int8: bool, lengths=None) -> bool:
    """Whether the wide stages over ``x`` run channels-last (module docstring):
    on the card, in a 16-bit dtype (cuDNN's f32 kernels are NCHW kernels), no
    int8 conv in the model and no lengths (the frame layouts of a
    length-masked encode are ``[B, C, T]``)."""
    return on_card(x) and x.dtype in (torch.bfloat16, torch.float16) and not int8 and lengths is None


def lrelu_channels_last(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """``lrelu(x [B, C, T])`` written straight into a channels-last ``[B, C, 1, T]``
    (in two passes where autograd records it: ``out=`` records no gradient)."""
    profiling.count("towers.layout_copies")
    x = x.unsqueeze(2)
    if torch.is_grad_enabled() and x.requires_grad:
        return lrelu(x.contiguous(memory_format=torch.channels_last), slope)
    return torch.ops.aten.leaky_relu.out(x, slope, out=torch.empty_like(x, memory_format=torch.channels_last))


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x [B, C, T]`` as a channels-last ``[B, C, 1, T]``: a view where each
    frame's channels are contiguous (``[B, T, C]`` transposed), else a copy."""
    x = x.unsqueeze(2)
    if x.is_contiguous(memory_format=torch.channels_last):
        return x
    profiling.count("towers.layout_copies")
    return x.contiguous(memory_format=torch.channels_last)


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """A channels-last ``[B, C, 1, T]`` as a contiguous ``[B, C, T]``; a 3-D ``x`` as it is."""
    if x.dim() == 3:
        return x
    profiling.count("towers.layout_copies")
    return x.squeeze(2).contiguous()


def _records_grad(x: torch.Tensor, *modules: Optional[nn.Module]) -> bool:
    """Whether autograd would record a stage over ``x`` with these modules' parameters."""
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(p.requires_grad for m in modules if m is not None for p in m.parameters())


def strided_length(n, kernel_size: int, stride: int):
    """Output length of an encoder stage's strided conv (padding ``(k - u) // 2``)
    over ``n`` valid samples: an int or an integer tensor."""
    return (n + 2 * ((kernel_size - stride) // 2) - kernel_size) // stride + 1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return int((kernel_size * dilation - dilation) / 2)


def stage_reach(kernel_sizes: Sequence[int], dilation_sizes: Sequence[Sequence[int]]) -> int:
    """The widest one-sided reach of a stage's resblock convs, ``max get_padding(k, d)``."""
    return max(get_padding(k, d) for k, ds in zip(kernel_sizes, dilation_sizes) for d in ds)


class Frames:
    """A layout of frames, as :class:`GroupNormTorch` and :func:`norm_chain` read
    it: the tensors that hold them (``parts``, ``join``), ``mask`` (None: every
    frame counts), ``average`` over each (row, group)'s valid frames and
    ``spread`` of its statistics back over the frames."""

    mask = None

    def parts(self, x):
        return [x]

    def join(self, ys, x):
        return ys[0]

    def masked(self, x):
        return masked(x, self.mask)

    def spread(self, s, v):
        return s


class Padded(Frames):
    """A zero-padded batch ``x [B, C, T]``: every frame valid, or row ``b``'s first
    ``count[b]`` (a length-masked encode; ``mask [B, 1, T]`` in ``x``'s dtype).
    ``host``: the counts on the host, if the caller gave them there (K4 counts
    its skipped tiles from them; a wide stage lays its rows out as :class:`Segments`)."""

    def __init__(self, count=None, host=None, x: Optional[torch.Tensor] = None):
        self.count, self.host = count, host
        self.mask = None if count is None else frame_mask(count, x.shape[2]).to(x.dtype)

    def average(self, vs, acc):
        """``[v [B, G, C / G, T]]`` -> ``[B, G, 1, 1]``."""
        (v,) = vs
        if self.mask is None:
            return v.mean(dim=(2, 3), keepdim=True)
        n = (self.count * v.shape[2]).reshape(-1, 1, 1, 1)
        return (v * self.mask.to(v.dtype)[:, None]).sum(dim=(2, 3), keepdim=True) / n


ALL_FRAMES = Padded()


class Segments(Frames):
    """The valid frames of a zero-padded batch ``[B, C, T]`` laid end to end in
    one row ``[1, C, N]``: row ``b``'s ``lengths[b]`` frames, then ``gap`` zero
    frames. With ``gap`` at least the reach of every "same" conv run over the
    row, each valid output frame sees the inputs and zeros that its row's
    exact-length conv sees. As a layout, each segment is a row of its own.

    ``lengths``: host integers (the offsets and ``N``, no sync); ``L``: the
    same on the batch's device, where the index tensors are built; ``dtype``:
    the batch's, that of ``mask``."""

    def __init__(self, lengths, L: torch.Tensor, gap: int, T: int, dtype: torch.dtype = torch.float32):
        self.lengths = [min(max(int(n), 0), T) for n in lengths]
        self.T = T
        self.offsets = [sum(self.lengths[:b]) + gap * b for b in range(len(self.lengths))]
        self.N = self.frames(self.lengths, gap, T)
        self.count = L.reshape(-1).long().clamp(0, T)
        span = self.count + gap
        start = torch.cumsum(span, 0) - span
        # each frame's row (a gap belongs to the row before it) and place in it
        self.row = torch.repeat_interleave(torch.arange(len(self.lengths), device=L.device), span,
                                           output_size=self.N)
        time = torch.arange(self.N, device=L.device) - start[self.row]
        # [1, 1, N]: the row's valid frames
        self.valid = (time < self.count[self.row])[None, None]
        self.mask = self.valid.to(dtype)
        self.time = time.clamp(max=T - 1)  # the padded frame each frame copies (a gap's is zeroed)
        # each padded frame's place in the row, and whether it is valid
        self.index = (start[:, None] + torch.arange(T, device=L.device)).clamp(max=max(self.N - 1, 0)).reshape(-1)
        self.padded_valid = frame_mask(self.count, T)[:, 0]

    @staticmethod
    def frames(lengths, gap: int, T: int) -> int:
        """``N`` for host ``lengths``."""
        return sum(min(max(int(n), 0), T) + gap for n in lengths)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, C, T]`` -> ``[1, C, N]``, the gaps zero: one indexed copy from ``x``'s
        channel planes (stride ``T``; row ``b``'s frame ``t`` at ``b C T + t``)."""
        B, C, T = x.shape
        planes = x.contiguous().as_strided((C, (B - 1) * C * T + T), (T, 1))
        return planes.index_select(1, self.row * (C * T) + self.time).masked_fill_(~self.valid[0], 0)[None]

    def scatter(self, y: torch.Tensor) -> torch.Tensor:
        """``[1, C, N]`` -> the zero-padded ``[B, C, T]``: one gather through
        ``index`` (broadcast over rows and channels, never materialized)."""
        B, C = len(self.lengths), y.shape[1]
        index = self.index.view(B, 1, self.T).expand(B, C, self.T)
        return torch.gather(y.expand(B, C, -1), 2, index).masked_fill_(~self.padded_valid[:, None], 0)

    def sums(self, v: torch.Tensor) -> torch.Tensor:
        """``v [G, N]`` -> ``[G, B]``: each segment's sum over its valid frames, in
        a fixed order (each segment's frames put back in its padded row, then
        summed)."""
        G = v.shape[0]
        vp = v[:, self.index].reshape(G, len(self.lengths), self.T)
        return torch.where(self.padded_valid, vp, 0.0).sum(-1)

    def average(self, vs, acc):
        """``[v [1, G, C / G, N]]`` -> ``[G, B]``; a segment of no valid frames
        (its frames are gaps) averages to zero, never 0 / 0."""
        (v,) = vs
        return self.sums(v.sum(2)[0]) / (self.count * v.shape[2]).clamp(min=1)

    def spread(self, s, v):
        """``s [G, B]`` -> ``[G, 1, N]``: each frame its segment's value."""
        return s[:, self.row][:, None]


def norm_chain(chains, norms, frames: Frames):
    """A stage's output: each GroupNorm normalizes the sum of the chain outputs so
    far (reference models.py:410-415), masked to ``frames``' valid frames; the
    last, over the chain count. A generator runs each chain as the loop reaches it."""
    xs = None
    for r, gn in zip(chains, norms):
        xs = frames.masked(gn(r if xs is None else xs + r, frames))
    return xs / len(norms)


@dataclass(frozen=True)
class HiFiCodecConfig:
    """The reference JSON config (egs/HiFi-Codec-*/config_*.json) as a dataclass."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 8, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    encoder_base_channels: int = 32  # reference hardcodes 32 (models.py:395)
    n_code_groups: int = 2
    n_codes: int = 1024
    codebook_loss_lambda: float = 1.0
    commitment_loss_lambda: float = 0.25
    sampling_rate: int = 24000
    segment_size: int = 16000
    num_mels: int = 80
    n_fft: int = 1024
    hop_size: int = 240
    win_size: int = 1024
    fmin: int = 0
    fmax: int = 8000
    fmax_for_loss: Any = None
    causal: bool = False  # the causal, streamable generator (the encoder stays non-causal)

    @property
    def latent_dim(self) -> int:
        """Encoder output width: base * 2^num_stages (512 at reference defaults)."""
        return self.encoder_base_channels * (2 ** len(self.upsample_rates))

    @classmethod
    def from_json(cls, d: dict) -> "HiFiCodecConfig":
        names = set(cls.__dataclass_fields__)
        kw = {}
        for k, v in d.items():
            if k in names:
                if isinstance(v, list):
                    v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
                kw[k] = v
        return cls(**kw)


def _res_conv(channels: int, kernel_size: int, dilation: int, norm: str, causal: bool = False,
              w8a8: bool = False):
    """A resblock conv: symmetric "same" zero padding, or its causal
    counterpart, all on the left (JAX nn/hifigan.py:88-122)."""
    if causal:
        if w8a8:
            raise ValueError("int8 serving has no causal variant")
        return SConv1d(channels, channels, kernel_size, dilation=dilation, norm=norm,
                       causal=True, pad_mode="zero")
    return Conv1d(channels, channels, kernel_size, dilation=dilation,
                  padding=get_padding(kernel_size, dilation), norm=norm, w8a8=w8a8)


def _inner_conv(m: nn.Module) -> nn.Module:
    """The ``Conv1d``/``ConvTranspose1d`` that holds an S-conv's parameters."""
    if isinstance(m, SConv1d):
        return m.conv.conv
    if isinstance(m, SConvTranspose1d):
        return m.convtr.convtr
    return m


class ResBlock1(nn.Module):
    """3x [lrelu -> dilated conv -> lrelu -> unit conv] with residual adds."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5),
                 norm: str = "weight_norm", causal: bool = False, w8a8: bool = False):
        super().__init__()
        self.convs1 = nn.ModuleList(_res_conv(channels, kernel_size, d, norm, causal, w8a8) for d in dilation)
        self.convs2 = nn.ModuleList(_res_conv(channels, kernel_size, 1, norm, causal, w8a8) for _ in dilation)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask [B, 1, T]`` (0/1) zeroes every conv's output past the valid
        frames, as the exact-length convs' zero padding would see them."""
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = masked(c1(lrelu(x)), mask)
            x = masked(c2(lrelu(xt)), mask) + x
        return x

    def stream(self, x: torch.Tensor, state=None):
        """One chunk of a causal block; ``state`` holds each conv's carried inputs."""
        state = list(state) if state is not None else [None] * (2 * len(self.convs1))
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt, state[2 * i] = c1.stream(lrelu(x), state[2 * i])
            xt, state[2 * i + 1] = c2.stream(lrelu(xt), state[2 * i + 1])
            x = xt + x
        return x, state

    def weights_and_biases(self):
        """Resolved ``(weights, biases)`` in call order convs1.0, convs2.0,
        convs1.1, ...: what the fused towers take."""
        convs = [c for pair in zip(self.convs1, self.convs2) for c in pair]
        return tuple(c.resolved_weight() for c in convs), tuple(c.bias for c in convs)


class ResBlock2(nn.Module):
    """2x [lrelu -> dilated conv] with residual adds."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3),
                 norm: str = "weight_norm", causal: bool = False, w8a8: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(_res_conv(channels, kernel_size, d, norm, causal, w8a8) for d in dilation)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for c in self.convs:
            x = masked(c(lrelu(x)), mask) + x
        return x

    def stream(self, x: torch.Tensor, state=None):
        state = list(state) if state is not None else [None] * len(self.convs)
        for i, c in enumerate(self.convs):
            xt, state[i] = c.stream(lrelu(x), state[i])
            x = xt + x
        return x, state

    def weights_and_biases(self):
        """Resolved ``(weights, biases)`` in call order convs.0, convs.1, ..."""
        return tuple(c.resolved_weight() for c in self.convs), tuple(c.bias for c in self.convs)


class GroupNormTorch(nn.Module):
    """GroupNorm with torch semantics: statistics over (channels of a group, time)."""

    def __init__(self, num_groups: int, channels: int, epsilon: float = 1e-6):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def accumulation(self, x: torch.Tensor, frames: Frames) -> Optional[torch.dtype]:
        """The dtype the statistics of ``x`` sum in: f64 for f32 on the card;
        else f32 when only some frames count (JAX nn/hifigan.py:239-280); else
        None, ``x``'s own, as ``frames`` averages it.

        On the card f32 inputs accumulate in f64, masked or not: CUDA's
        reductions pick their order from the reduced length, so f32 sums over
        a zero-padded row and over the same row at its exact length part by
        an ulp, and the tokens of a batched encode part from a single one's at
        near-ties (ROADMAP.md Queue 3 item 3). In f64 both round to the same
        f32 statistics. bf16 serving keeps its sums: its tokens are not held
        batched against single, and f64 passes over the wide stages cost it time."""
        if x.is_cuda and x.dtype == torch.float32:
            return torch.float64
        return torch.float32 if frames.mask is not None else None

    def forward(self, x, frames: Frames = ALL_FRAMES):
        """``x`` laid out as ``frames`` says: the mean and then the variance are
        ``frames``' averages of ``x`` and of its squared deviations, in the
        :meth:`accumulation` dtype, each rounded back to ``x``'s dtype once."""
        parts = frames.parts(x)
        xg = [p.reshape(p.shape[0], self.num_groups, -1, p.shape[-1]) for p in parts]
        acc = self.accumulation(parts[0], frames)
        xf = xg if acc is None else [v.to(acc) for v in xg]
        # without acc the deviations are taken from the mean in x's dtype, as Tensor.mean gives it
        mean = frames.average(xf, acc).to(xf[0].dtype)
        var = frames.average([(v - frames.spread(mean, v)).square() for v in xf], acc).to(xf[0].dtype)
        mean, var = mean.to(parts[0].dtype), var.to(parts[0].dtype)
        scale = torch.rsqrt(var + self.epsilon)
        ys = [((v - frames.spread(mean, v)) * frames.spread(scale, v)).reshape(p.shape)
              * self._per_channel(self.weight, p) + self._per_channel(self.bias, p) for v, p in zip(xg, parts)]
        return frames.join(ys, x)

    @staticmethod
    def _per_channel(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """``w [C]`` broadcast over ``p [B, C, T]`` or ``[B, C, 1, T]``."""
        return w.reshape((-1,) + (1,) * (p.dim() - 2)).to(p.device)


class PackedStage:
    """The packed operands of one fused stage (:func:`pack_tower`), rebuilt
    when a parameter of its convs was updated in place, replaced, cast or
    moved. Nothing is kept with gradients enabled or for parameters that are
    not ``nn.Parameter`` leaves (``torch.func.functional_call``'s copies, whose
    storage a later copy may reuse): every such call packs the current
    weights. An update that leaves the version counter as it was (torch's
    fused optimizers) must be followed by :meth:`invalidate`."""

    def __init__(self):
        self.key, self.packed = None, None

    def get(self, blocks, kernel_sizes, dilation_sizes, resblock: str, post=None, pre=None) -> PackedTower:
        """``post``: the conv fused behind the tower; ``pre``: the upsampling
        ``ConvTranspose1d`` fused in front of it (K3's prologue)."""
        def build():
            ws, bs = zip(*(rb.weights_and_biases() for rb in blocks))
            kw = {} if post is None else dict(post_weight=post.resolved_weight(), post_bias=post.bias)
            if pre is not None:
                kw.update(pre_weight=pre.resolved_weight(), pre_bias=pre.bias, pre_stride=pre.stride,
                          pre_pad=pre.padding)
            return pack_tower(ws, bs, kernel_sizes=kernel_sizes, dilation_sizes=dilation_sizes,
                              resblock=resblock, **kw)

        params = [p for rb in blocks for p in rb.parameters()]
        for m in (post, pre):
            if m is not None:
                params += list(m.parameters())
        if torch.is_grad_enabled() or not all(isinstance(p, nn.Parameter) for p in params):
            return build()
        key = tuple((p._version, p.dtype, p.device, p.data_ptr()) for p in params)
        if key != self.key:
            self.key, self.packed = key, build()
        return self.packed

    def invalidate(self) -> None:
        self.key, self.packed = None, None


def invalidate_packed(module: nn.Module) -> None:
    """Drop the packed operands of every fused stage under ``module``."""
    for m in module.modules():
        for st in getattr(m, "_packed", None) or ():
            st.invalidate()


def _resblock_cls(h: HiFiCodecConfig):
    return ResBlock1 if h.resblock == "1" else ResBlock2


def stage_w8a8(channels: int, int8_min_channels: int) -> bool:
    """Whether a stage's resblock convs serve int8: at least ``int8_min_channels``
    (> 0) channels and too wide for the fused towers."""
    return 0 < int8_min_channels <= channels and channels > FUSED_MAX_CHANNELS


class HiFiGANEncoder(nn.Module):
    """The mirrored generator used as the HiFi-Codec encoder:
    ``[B, 1, T]`` -> ``[B, latent_dim, frames]``."""

    def __init__(self, config: HiFiCodecConfig, norm: str = "weight_norm", int8_min_channels: int = 0):
        super().__init__()
        h = self.config = config
        base = h.encoder_base_channels
        self.ups_cfg = list(reversed(list(zip(h.upsample_rates, h.upsample_kernel_sizes))))
        self.rks = tuple(reversed(h.resblock_kernel_sizes))
        self.rds = tuple(tuple(d) for d in reversed(h.resblock_dilation_sizes))
        nk = len(self.rks)
        self.conv_pre = Conv1d(1, base, 7, padding=3, norm=norm)
        ups, resblocks, norms = [], [], []
        self.int8 = False
        for i, (u, k) in enumerate(self.ups_cfg):
            ch = base * 2 ** (i + 1)
            if ch < 16:
                raise ValueError(
                    f"encoder_base_channels={base} too small: stage {i} has {ch} channels "
                    "but GroupNorm uses ch//16 groups (reference models.py:412)"
                )
            ups.append(Conv1d(base * 2 ** i, ch, k, stride=u, padding=(k - u) // 2, norm=norm))
            w8a8 = stage_w8a8(ch, int8_min_channels)
            self.int8 |= w8a8
            for j in range(nk):
                resblocks.append(_resblock_cls(h)(ch, self.rks[j], self.rds[j], norm=norm, w8a8=w8a8))
                norms.append(GroupNormTorch(ch // 16, ch, epsilon=1e-6))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        self.normalize = nn.ModuleList(norms)
        self.conv_post = Conv1d(h.latent_dim, h.latent_dim, 3, padding=1, norm="none")
        self._packed = [PackedStage() for _ in self.ups_cfg]

    def normal_init_convs(self):
        """The convs the JAX package draws from N(0, 0.01^2) (nn/hifigan.py:35-37)."""
        return [*self.ups, self.conv_post]

    def stage(self, i: int):
        """Stage ``i``'s resblocks and their GroupNorms."""
        nk = len(self.rks)
        return self.resblocks[i * nk:(i + 1) * nk], self.normalize[i * nk:(i + 1) * nk]

    def fused_stage(self, i: int) -> bool:
        """Whether stage ``i`` is narrow enough for K4."""
        return self.config.encoder_base_channels * 2 ** (i + 1) <= FUSED_MAX_CHANNELS

    def packed_tower(self, i: int) -> PackedTower:
        """Stage ``i``'s resblocks packed for K4 (kept until a weight changes)."""
        return self._packed[i].get(self.stage(i)[0], self.rks, self.rds, self.config.resblock)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [B, 1, T]``; ``lengths [B]``: the valid samples of each row of a
        zero-padded batch (the length-masked encode; frames past a row's
        valid output frames are not meaningful). Returns ``[B, D, frames]``, each
        frame's channels contiguous where the wide stages ran channels-last."""
        x = self.conv_pre(x)
        frames = ALL_FRAMES
        if lengths is not None:
            host = torch.as_tensor(lengths).reshape(-1).long() if on_host(lengths) else None
            frames = Padded(torch.as_tensor(lengths, device=x.device).reshape(-1).long(), host, x)
        x = frames.masked(x)  # the conv's bias leaks into the pad frames
        cl = channels_last_stages(x, self.int8, lengths)
        for i, (ups, (u, k)) in enumerate(zip(self.ups, self.ups_cfg)):
            # the first wide stage's strided conv takes the channels-last layout
            enter = cl and x.dim() == 3 and not self.fused_stage(i)
            x = ups(lrelu_channels_last(x) if enter else lrelu(x))
            if frames.count is not None:
                host = None if frames.host is None else strided_length(frames.host, k, u)
                frames = Padded(strided_length(frames.count, k, u), host, x)
            x = frames.masked(x)  # rebound: the unmasked output must not stay alive through the stage
            x = self.stage_forward(i, x, frames)
        y = self.conv_post(lrelu(x, 0.01))  # default torch slope (models.py:417)
        return y.squeeze(2) if y.dim() == 4 else y

    def stage_forward(self, i: int, x: torch.Tensor, frames: Padded = ALL_FRAMES) -> torch.Tensor:
        """Stage ``i``'s resblocks and chained GroupNorms over ``x``, the output of
        its strided conv (``[B, C, T]``, or ``[B, C, 1, T]`` channels-last), laid
        out as ``frames`` says. Given host counts, an unfused stage runs on
        :class:`Segments` when they are fewer frames than the batch."""
        blocks, norms = self.stage(i)
        if self.fused_stage(i) and not _records_grad(x, *blocks, *norms):
            return resblock_tower_gn(
                x, self.packed_tower(i), None,
                torch.stack([n.weight for n in norms]), torch.stack([n.bias for n in norms]),
                num_groups=x.shape[1] // 16, epsilon=1e-6,
                lengths=frames.count if frames.host is None else frames.host,
            )
        B, T = x.shape[0], x.shape[-1]
        layout = frames
        if frames.host is not None and not _records_grad(x, *blocks, *norms):
            lengths, gap = frames.host.tolist(), stage_reach(self.rks, self.rds)
            if 0 < Segments.frames(lengths, gap, T) < B * T:
                layout = Segments(lengths, frames.count, gap, T, x.dtype)
                x = layout.gather(x)
        if not self.fused_stage(i):
            profiling.count("encoder.frames", B * T)
            profiling.count("encoder.frames_computed", B * T if layout is frames else layout.N)
        y = norm_chain((rb(x, layout.mask) for rb in blocks), norms, layout)
        return y if layout is frames else layout.scatter(y)


class HiFiGANGenerator(nn.Module):
    """HiFi-GAN generator: ``[B, latent_dim, frames]`` -> ``[B, 1, T]``; causal
    and streamable when ``config.causal`` (JAX nn/hifigan.py:528-560, 640-722).

    ``fused_pre=True`` (JAX ``HiFiGANGenerator(fused_pre=True)``,
    nn/hifigan.py:517, 586-630) hands each fused stage's lrelu and upsampling
    conv-transpose to K3 as its prologue, so that the upsampled tensor is
    never written out; the default runs them as PyTorch ops, as JAX does by
    default. Causal generators never run K3 and ignore it."""

    def __init__(self, config: HiFiCodecConfig, norm: str = "weight_norm", fused_pre: bool = False,
                 int8_min_channels: int = 0):
        super().__init__()
        self.fused_pre = fused_pre
        h = self.config = config
        if int8_min_channels and h.causal:
            raise ValueError("int8 serving has no causal variant")
        nk = len(h.resblock_kernel_sizes)
        self.int8 = False
        causal = dict(causal=True, pad_mode="zero", norm=norm)
        if h.causal:
            self.conv_pre = SConv1d(h.latent_dim, h.upsample_initial_channel, 7, **causal)
        else:
            self.conv_pre = Conv1d(h.latent_dim, h.upsample_initial_channel, 7, padding=3, norm=norm)
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            cin = h.upsample_initial_channel // 2 ** i
            cout = h.upsample_initial_channel // 2 ** (i + 1)
            if h.causal:
                ups.append(SConvTranspose1d(cin, cout, k, stride=u, causal=True, trim_right_ratio=1.0,
                                            norm=norm))
            else:
                ups.append(ConvTranspose1d(cin, cout, k, stride=u, padding=(k - u) // 2, norm=norm))
            w8a8 = stage_w8a8(cout, int8_min_channels)
            self.int8 |= w8a8
            for j in range(nk):
                resblocks.append(_resblock_cls(h)(cout, h.resblock_kernel_sizes[j], h.resblock_dilation_sizes[j],
                                                  norm=norm, causal=h.causal, w8a8=w8a8))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        c_post = h.upsample_initial_channel // 2 ** len(ups)
        if h.causal:
            self.conv_post = SConv1d(c_post, 1, 7, **causal)
        else:
            self.conv_post = Conv1d(c_post, 1, 7, padding=3, norm=norm)
        self._packed = [PackedStage() for _ in ups]

    def normal_init_convs(self):
        """The convs the JAX package draws from N(0, 0.01^2) (nn/hifigan.py:35-37)."""
        return [_inner_conv(m) for m in (*self.ups, self.conv_post)]

    def stage(self, i: int):
        """Stage ``i``'s resblocks."""
        nk = len(self.config.resblock_kernel_sizes)
        return self.resblocks[i * nk:(i + 1) * nk]

    def fused_stage(self, i: int) -> bool:
        """Whether stage ``i`` is narrow enough for K3 (never for a causal generator)."""
        h = self.config
        return h.upsample_initial_channel // 2 ** (i + 1) <= FUSED_MAX_CHANNELS and not h.causal

    def packed_tower(self, i: int, post=None, pre=None) -> PackedTower:
        """Stage ``i``'s resblocks packed for K3, with the ``conv_post`` fused
        behind them and the upsampling ``ConvTranspose1d`` in front (kept until a
        weight changes)."""
        h = self.config
        return self._packed[i].get(self.stage(i), tuple(h.resblock_kernel_sizes),
                                   tuple(tuple(d) for d in h.resblock_dilation_sizes), h.resblock, post, pre)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, latent_dim, frames]`` -> ``[B, 1, T]``. Where the wide stages run
        channels-last, ``x`` with each frame's channels contiguous (the decode's
        ``q.transpose(1, 2)``) enters the layout as a view."""
        nk = len(self.config.resblock_kernel_sizes)
        if channels_last_stages(x, self.int8) and not self.config.causal and not self.fused_stage(0):
            x = channels_last(x)
        else:
            x = x.contiguous()
        x = self.conv_pre(x)
        n_up = len(self.ups)
        for i, ups in enumerate(self.ups):
            blocks = self.stage(i)
            last = i == n_up - 1
            if self.fused_stage(i) and not _records_grad(x, *blocks, ups, self.conv_post if last else None):
                # conv_post and tanh run inside the last tower; with fused_pre
                # lrelu and the upsampling convT run in front of it
                post = self.conv_post if last else None
                pre = ups if self.fused_pre else None
                if pre is None:
                    x = ups(lrelu(x))
                x = resblock_tower(channels_first(x), self.packed_tower(i, post, pre), post_tanh=post is not None)
                if post is not None:
                    return x
                continue
            x = ups(lrelu(x))
            xs = None
            for rb in blocks:
                r = rb(x)
                xs = r if xs is None else xs + r
            x = xs / nk
        y = torch.tanh(self.conv_post(lrelu(x)))
        return y.squeeze(2) if y.dim() == 4 else y

    def stream(self, x: torch.Tensor, state=None):
        """One chunk of latent frames ``[B, latent_dim, frames]`` (any count) and
        the state the last chunk left (None starts a stream) -> ``(wav chunk
        [B, 1, frames * hop], next state)``. Causal generators only."""
        if not self.config.causal:
            raise ValueError("streaming decode needs a causal config")
        nk = len(self.config.resblock_kernel_sizes)
        if state is None:
            state = (None, [None] * len(self.ups), [None] * len(self.resblocks), None)
        pre, ups_states, res_states, post = state
        ups_states, res_states = list(ups_states), list(res_states)
        x, pre = self.conv_pre.stream(x, pre)
        for i, ups in enumerate(self.ups):
            x, ups_states[i] = ups.stream(lrelu(x), ups_states[i])
            xs = None
            for j in range(i * nk, (i + 1) * nk):
                r, res_states[j] = self.resblocks[j].stream(x, res_states[j])
                xs = r if xs is None else xs + r
            x = xs / nk
        y, post = self.conv_post.stream(lrelu(x), post)
        return torch.tanh(y), (pre, ups_states, res_states, post)
