"""Conv layers with weight norm and streaming-safe padding, on ``[B, C, T]``.

Parameters use the reference PyTorch layouts and names: ``weight_v`` /
``weight_g`` (torch ``weight_norm(dim=0)``) or a plain ``weight``, with
``[O, I, K]`` conv, ``[I, O, K]`` conv-transpose and ``[O, I, kh, kw]``
``Conv2d`` kernels. Weight norm is resolved on every call as ``g * v /
||v||`` with no eps, exactly as ``academicodec_tpu/nn/conv.py`` does: per
out-channel for conv, per in-channel for conv-transpose. The resolution is
plain differentiable torch, so under autograd the gradients reach ``g`` and
``v`` (the discriminators and the trainer train through it).

Spectral norm (``norm="spectral_norm"``, the first scale of the HiFi-Codec
multi-scale discriminator) holds a plain ``weight`` and its power-iteration
vector ``weight_u`` (a buffer, the JAX ``'spectral'`` collection's
``kernel_u``) and divides the weight by ``sigma = u^T W v`` on every call,
with ``u`` and ``v`` detached (JAX nn/conv.py:99-127). ``forward(x,
advance=True)`` is JAX's mutable apply: one power-iteration step from the
stored ``u``, whose result is stored and used; the default is its
non-mutable apply, which uses the stored ``u`` as it is. The trainer says
where ``u`` advances (once a step); ``torch.nn.utils.spectral_norm``, whose
hook advances it on every training call, is not used.

``NormConv1d`` / ``NormConvTranspose1d`` add the reference's extra module
level, so state-dict keys read ``conv.conv.weight_v`` and
``convtr.convtr.weight_v`` as in a reference checkpoint. ``NormConv1d`` also
holds the post-conv norms ``layer_norm`` and ``time_group_norm`` (a plain
kernel, then ``nn/norm.py`` on the conv's output, keys ``conv.norm.weight``
/ ``conv.norm.bias``); a conv-transpose with either mode keeps a plain
kernel and no norm, as the JAX package's ``ConvTranspose1d`` does.

``Conv1d`` and ``ConvTranspose1d`` also take a 4-D ``[B, C, 1, T]`` input,
the layout in which the HiFi-Codec wide stages run bf16 on the card
(``nn/hifigan.py``): a channels-last tensor, each frame's channels
contiguous, which cuDNN's 16-bit kernels read and write as they are. It runs
as ``F.conv2d`` / ``F.conv_transpose2d`` with the kernel viewed as ``[O, I,
1, K]`` (``[I, O, 1, K]``) and stored channels-last, stride, dilation and
padding on the time axis, and gives a channels-last ``[B, O, 1, T']``
(``F.conv1d`` would make a 3-D view of that layout contiguous first). A
dilated conv runs as the undilated conv of its interleaved phases
(:func:`conv_phases`): for the dilated 2-D conv at 512 channels (k 11 at d
3 and 5, k 7 at d 5) cuDNN's heuristics pick a direct kernel ~600x slower
than the phases' implicit GEMM (89-139 ms against 0.15-0.21 ms at 16 x 750
frames; H100, cuDNN 9.22). Each such call counts ``towers.cl_convs``
(``utils/profiling.py``). A 3-D input runs the 1-D conv as before; a
``w8a8`` conv takes 3-D inputs only.

``Conv1d(w8a8=True)`` is the W8A8 int8 serving conv of ``ops/int8.py``: its
static activation scale, ``act_amax`` (max |input|), is recorded by a
calibration pass (``calibrating = True``, full-precision conv meanwhile;
``models/hificodec.calibrate_quant``) and is not part of the state dict,
so reference checkpoints load unchanged.

Streaming (causal convs only, not with ``time_group_norm``, whose
statistics span the whole utterance): ``SConv1d.stream`` and
``SConvTranspose1d.stream`` take one chunk and the state the previous chunk
left, and return the output and the next state, so that chunk after chunk
equals one full-length call (exactly for ``pad_mode='zero'`` models). The
state is a plain tensor that the caller keeps; ``None`` starts a stream.
:func:`stream_layers` runs a sequence of modules this way.

Behavioral parity targets: academicodec_tpu/nn/conv.py (SConv1d,
SConvTranspose1d); reference academicodec/modules/conv.py:213-323.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from academicodec_tpu_torch.nn.norm import POST_NORMS
from academicodec_tpu_torch.ops.int8 import act_scale_from_amax, conv1d_w8a8
from academicodec_tpu_torch.ops.padding import get_extra_padding_for_conv1d, pad1d, unpad1d
from academicodec_tpu_torch.utils import profiling

# norms of a kernel itself; the S-convs also take the post-conv norms of nn/norm.py
KERNEL_NORMS = ("none", "weight_norm", "spectral_norm")
SPECTRAL_EPS = 1e-12  # inside each norm of the power iteration, as in JAX
NORMS = KERNEL_NORMS + tuple(POST_NORMS)


def _kernel_norm(norm: str) -> str:
    if norm not in NORMS:
        raise ValueError(f"unsupported norm {norm!r}; the port has {NORMS}")
    return "none" if norm in POST_NORMS else norm


class _NormedWeight(nn.Module):
    """A kernel held plain (``weight``), weight-normed (``weight_v``/``weight_g``)
    or spectral-normed (``weight`` and the buffer ``weight_u``)."""

    def _make_weight(self, shape, norm: str) -> None:
        if norm not in KERNEL_NORMS:
            raise ValueError(f"unsupported kernel norm {norm!r}; a kernel has {KERNEL_NORMS}")
        self.norm = norm
        if norm == "weight_norm":
            self.weight_v = nn.Parameter(torch.empty(shape))
            self.weight_g = nn.Parameter(torch.empty((shape[0],) + (1,) * (len(shape) - 1)))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        if norm == "spectral_norm":
            self.register_buffer("weight_u", torch.empty(shape[0]))

    def _init_weight(self, generator: torch.Generator, fan_in: int, normal_std=None) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            w = self.weight_v if self.norm == "weight_norm" else self.weight
            if normal_std is None:
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))
            else:
                w.copy_(torch.empty(w.shape).normal_(0.0, normal_std, generator=generator))
            if self.norm == "weight_norm":  # g <- ||v||: the initial weight equals v
                self.weight_g.copy_(_channel_norm(w))
            if self.bias is not None:
                self.bias.copy_(
                    torch.empty(self.bias.shape).uniform_(-bound, bound, generator=generator)
                )
            if self.norm == "spectral_norm":  # u ~ N(0, 1), as JAX draws it
                self.weight_u.copy_(torch.empty(self.weight_u.shape).normal_(generator=generator))

    def resolved_weight(self, advance: bool = False) -> torch.Tensor:
        """The kernel the conv applies; ``advance`` steps a spectral norm's ``u``
        (module docstring) and is ignored by the other norms."""
        if self.norm == "weight_norm":
            return self.weight_g * self.weight_v / _channel_norm(self.weight_v)
        if self.norm == "spectral_norm":
            return spectral_normalize(self.weight, self.weight_u, advance)
        return self.weight


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (v.norm() + SPECTRAL_EPS)


def spectral_normalize(w: torch.Tensor, u_buf: torch.Tensor, advance: bool) -> torch.Tensor:
    """``w / sigma`` with ``sigma = u^T W v`` of ``W = w.reshape(out, -1)`` in f32:
    ``v = unit(W^T unit(u))``; with ``advance`` ``u = unit(W v)`` is stored in
    ``u_buf`` and used, else the stored ``unit(u)`` is used. ``u`` and ``v``
    carry no gradient (JAX nn/conv.py:99-127)."""
    w_mat = w.reshape(w.shape[0], -1).float()
    with torch.no_grad():
        u = _unit(u_buf.float())
        v = _unit(w_mat.t() @ u)
        if advance:
            u = _unit(w_mat @ v)
            u_buf.copy_(u)
    sigma = torch.dot(u, w_mat @ v)
    return (w.float() / sigma).to(w.dtype)


def _channel_norm(v: torch.Tensor) -> torch.Tensor:
    return v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()


def channels_last_kernel(w: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """A 1-D conv kernel ``[O, I, K]`` as the ``[O, I, 1, K]`` channels-last kernel
    of a conv over ``[B, C, 1, T]`` (module docstring); ``axis`` 3: ``[O, I, K, 1]``."""
    return w.unsqueeze(axis).contiguous(memory_format=torch.channels_last)


def conv_phases(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], dilation: int, padding: int,
                groups: int = 1) -> torch.Tensor:
    """The conv of ``x [B, C, 1, T]`` channels-last with the kernel ``w [O, I, K]``
    dilated by ``d``, stride 1 and ``padding`` a multiple of ``d``, as an undilated
    ``(K, 1)`` conv over the view ``[B, C, T / d, d]``: frame ``j d + r`` is row
    ``j`` of column ``r``, so each column is one phase of the dilated conv, and
    the rows' zero padding is the frames' (``padding / d`` rows each side). Where
    ``d`` does not divide ``T``, zero frames pad the end (the frames the conv's
    own zero padding reads there) and the output is cropped to ``T``."""
    B, C, _, T = x.shape
    d = dilation
    Tp = -(-T // d) * d
    if Tp != T:
        x = F.pad(x, (0, Tp - T))
    y = F.conv2d(x.view(B, C, Tp // d, d), channels_last_kernel(w, 3), bias, padding=(padding // d, 0),
                 groups=groups)
    y = y.view(B, y.shape[1], 1, Tp)
    return y if Tp == T else y[..., :T].contiguous(memory_format=torch.channels_last)


class Conv1d(_NormedWeight):
    """Cross-correlation over ``[B, C, T]`` with a ``[O, I/groups, K]`` kernel
    and ``padding`` zeros on each side (the HiFi-Codec convs' fixed "same"
    padding; academicodec_tpu/nn/conv.py:128-229). ``w8a8``: int8 serving
    once calibrated (module docstring)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        norm: str = "none",
        padding: int = 0,
        w8a8: bool = False,
    ):
        super().__init__()
        if w8a8 and groups != 1:
            raise ValueError("w8a8 convs have groups=1 only")
        self.stride, self.dilation, self.groups, self.padding = stride, dilation, groups, padding
        self.fan_in = (in_channels // groups) * kernel_size
        self._make_weight((out_channels, in_channels // groups, kernel_size), norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.w8a8, self.calibrating = w8a8, False
        self.act_amax: Optional[torch.Tensor] = None  # f32 scalar once calibrated

    def reset_parameters(self, generator: torch.Generator, normal_std=None) -> None:
        """Torch's default uniform init, or N(0, normal_std^2) weights."""
        self._init_weight(generator, self.fan_in, normal_std)

    def forward(self, x: torch.Tensor, advance: bool = False, *, add_bias: bool = True) -> torch.Tensor:
        """``x [B, C, T]``, or ``[B, C, 1, T]`` channels-last (module docstring);
        ``advance``: step a spectral norm's ``u`` in this call; ``add_bias`` False:
        the conv without its bias (the caller adds it, as ``nn/dac.py``'s epilogues do)."""
        bias = self.bias if add_bias else None
        if x.dim() == 4:
            if self.w8a8:
                raise ValueError("a w8a8 Conv1d takes [B, C, T] inputs only, not a channels-last [B, C, 1, T]")
            profiling.count("towers.cl_convs")
            w = self.resolved_weight(advance)
            if self.dilation > 1 and self.stride == 1 and self.padding % self.dilation == 0:
                return conv_phases(x, w, bias, self.dilation, self.padding, self.groups)
            return F.conv2d(
                x, channels_last_kernel(w), bias, stride=(1, self.stride),
                padding=(0, self.padding), dilation=(1, self.dilation), groups=self.groups,
            )
        if self.w8a8:
            if self.calibrating:  # record max |x|, convolve at full precision
                amax = x.detach().abs().max().float()
                self.act_amax = amax if self.act_amax is None else torch.maximum(self.act_amax, amax)
            elif self.act_amax is None:
                raise ValueError(
                    "a w8a8 Conv1d has no calibrated act_amax: run "
                    "models.hificodec.calibrate_quant on the model first"
                )
            else:
                return conv1d_w8a8(
                    x, self.resolved_weight(), bias,
                    act_scale_from_amax(self.act_amax.to(x.device)), stride=self.stride,
                    dilation=self.dilation, padding=(self.padding, self.padding),
                )
        return F.conv1d(
            x, self.resolved_weight(advance), bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
        )


class ConvTranspose1d(_NormedWeight):
    """Transposed conv over ``[B, C, T]`` with an ``[I, O/groups, K]`` kernel; ``padding``
    has torch's meaning, that much output cut from each side
    (academicodec_tpu/nn/conv.py:231-321). ``groups`` as in torch (``groups =
    I = O``: depthwise)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        bias: bool = True,
        norm: str = "none",
        padding: int = 0,
        groups: int = 1,
    ):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.fan_in = out_channels // groups * kernel_size  # torch convT fan_in = (out / groups) * k
        self._make_weight((in_channels, out_channels // groups, kernel_size), norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator: torch.Generator, normal_std=None) -> None:
        """Torch's default uniform init, or N(0, normal_std^2) weights."""
        self._init_weight(generator, self.fan_in, normal_std)

    def forward(self, x: torch.Tensor, *, add_bias: bool = True) -> torch.Tensor:
        """``x [B, C, T]``, or ``[B, C, 1, T]`` channels-last (module docstring);
        ``add_bias`` as :meth:`Conv1d.forward`'s."""
        bias = self.bias if add_bias else None
        if x.dim() == 4:
            profiling.count("towers.cl_convs")
            return F.conv_transpose2d(
                x, channels_last_kernel(self.resolved_weight()), bias, stride=(1, self.stride),
                padding=(0, self.padding), groups=self.groups,
            )
        return F.conv_transpose1d(
            x, self.resolved_weight(), bias, stride=self.stride, padding=self.padding, groups=self.groups
        )


class Conv2d(_NormedWeight):
    """Cross-correlation over ``[B, C, H, W]`` with an ``[O, I/groups, kh, kw]``
    kernel (torch's layout), a kernel norm (weight norm per out-channel),
    and ``padding`` zeros ``(ph, pw)`` on both sides of each dim
    (academicodec_tpu/nn/conv.py:324-365, whose kernels are ``[kh, kw, I, O]``
    on ``[B, H, W, C]``)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, int],
        stride: Tuple[int, int] = (1, 1),
        dilation: Tuple[int, int] = (1, 1),
        padding: Tuple[int, int] = (0, 0),
        groups: int = 1,
        bias: bool = True,
        norm: str = "none",
    ):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.dilation, self.padding, self.groups = tuple(stride), tuple(dilation), tuple(padding), groups
        self.fan_in = (in_channels // groups) * kh * kw
        self._make_weight((out_channels, in_channels // groups, kh, kw), norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator: torch.Generator, normal_std=None) -> None:
        """Torch's default uniform init, or N(0, normal_std^2) weights."""
        self._init_weight(generator, self.fan_in, normal_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(
            x, self.resolved_weight(), self.bias, stride=self.stride, padding=self.padding,
            dilation=self.dilation, groups=self.groups,
        )


class NormConv1d(nn.Module):
    """``Conv1d`` and its post-conv norm (``nn.Identity`` unless ``layer_norm``
    or ``time_group_norm``)."""

    def __init__(self, in_channels: int, out_channels: int, *args, norm: str = "none", **kwargs):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, *args, norm=_kernel_norm(norm), **kwargs)
        self.norm_type = norm
        self.norm = POST_NORMS[norm](out_channels) if norm in POST_NORMS else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class NormConvTranspose1d(nn.Module):
    """``ConvTranspose1d``; the post-conv norms leave its kernel plain and add
    nothing (JAX nn/conv.py:231-321 applies none)."""

    def __init__(self, *args, norm: str = "none", **kwargs):
        super().__init__()
        self.convtr = ConvTranspose1d(*args, norm=_kernel_norm(norm), **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convtr(x)


class SConv1d(nn.Module):
    """Conv1d with causal or centred padding that keeps the framing exact.

    ``padding_total = (k-1)*d - (s-1)``; causal puts it all on the left,
    otherwise ``left = total - total//2``. Extra right padding makes the
    last window full, so encode/decode round trips preserve length.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        causal: bool = False,
        norm: str = "weight_norm",
        pad_mode: str = "reflect",
    ):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.causal, self.pad_mode = causal, pad_mode
        self.conv = NormConv1d(
            in_channels, out_channels, kernel_size, stride=stride, dilation=dilation,
            groups=groups, bias=bias, norm=norm,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.kernel_size, self.stride, self.dilation
        padding_total = (k - 1) * d - (s - 1)
        extra = get_extra_padding_for_conv1d(x.shape[-1], k, s, padding_total)
        if self.causal:
            pads = (padding_total, extra)
        else:
            pad_right = padding_total // 2
            pads = (padding_total - pad_right, pad_right + extra)
        return self.conv(pad1d(x, pads, mode=self.pad_mode))

    def stream(self, x: torch.Tensor, buf: Optional[torch.Tensor] = None):
        """One chunk ``[B, C, Tc]`` (``Tc`` a multiple of the stride) -> ``(y [B, O,
        Tc / stride], next buf)``. ``buf`` holds the last ``padding_total`` inputs,
        zeros at the start of a stream, in the input's dtype (JAX nn/conv.py:415-438)."""
        if not self.causal:
            raise ValueError("streaming needs a causal conv")
        if self.conv.norm_type == "time_group_norm":
            raise ValueError("time_group_norm does not stream: its statistics span the whole utterance")
        k, s, d = self.kernel_size, self.stride, self.dilation
        if x.shape[-1] % s:
            raise ValueError(f"a stream chunk of {x.shape[-1]} samples is not a multiple of the stride {s}")
        padding_total = (k - 1) * d - (s - 1)
        if buf is None:
            buf = x.new_zeros((x.shape[0], x.shape[1], padding_total))
        x = torch.cat([buf, x], dim=-1)
        return self.conv(x), x[..., x.shape[-1] - padding_total:].clone()  # not a view of the chunk


class SConvTranspose1d(nn.Module):
    """ConvTranspose1d whose ``k - s`` surplus samples are trimmed:
    ``ceil(total * trim_right_ratio)`` on the right when causal, otherwise
    ``total//2`` on the right and the rest on the left."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        causal: bool = False,
        trim_right_ratio: float = 1.0,
        bias: bool = True,
        norm: str = "weight_norm",
        groups: int = 1,
    ):
        super().__init__()
        if not (causal or trim_right_ratio == 1.0):
            raise ValueError("trim_right_ratio != 1 needs a causal conv-transpose")
        self.kernel_size, self.stride = kernel_size, stride
        self.causal, self.trim_right_ratio = causal, trim_right_ratio
        self.convtr = NormConvTranspose1d(
            in_channels, out_channels, kernel_size, stride=stride, bias=bias, norm=norm, groups=groups
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding_total = self.kernel_size - self.stride
        if self.causal:
            pad_right = math.ceil(padding_total * self.trim_right_ratio)
        else:
            pad_right = padding_total // 2
        return unpad1d(self.convtr(x), (padding_total - pad_right, pad_right))

    def stream(self, x: torch.Tensor, tail: Optional[torch.Tensor] = None):
        """One chunk ``[B, C, Tc]`` -> ``(y [B, O, Tc * stride], next tail)`` by
        overlap-add: the bias-free last ``k - s`` outputs carry into the next
        chunk, and the bias is added once (JAX nn/conv.py:284-300, 504-512)."""
        if not (self.causal and self.trim_right_ratio == 1.0):
            raise ValueError("streaming needs a causal conv-transpose with trim_right_ratio 1")
        conv = self.convtr.convtr
        y = F.conv_transpose1d(x, conv.resolved_weight(), None, stride=self.stride, groups=conv.groups)
        emit = x.shape[-1] * self.stride
        if tail is not None:
            y[..., : tail.shape[-1]] += tail
        out = y[..., :emit]
        if conv.bias is not None:
            out = out + conv.bias[:, None]
        return out, y[..., emit:].clone()  # the state holds the k - s tail, not the chunk


def stream_layers(layers, x: torch.Tensor, states: Optional[list] = None):
    """Run ``layers`` in order on one stream chunk. A layer with a ``stream``
    method takes its entry of ``states`` and gives back the next one; the
    others are called plainly and keep None. Returns ``(y, next states)``."""
    states = [None] * len(layers) if states is None else states
    out = []
    for layer, state in zip(layers, states):
        if hasattr(layer, "stream"):
            x, state = layer.stream(x, state)
        else:
            x = layer(x)
        out.append(state)
    return x, out
