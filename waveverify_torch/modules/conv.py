"""Smart-padded 1-D convolutions with weight normalization, in PyTorch.

Counterpart of ``waveverify_tpu/modules/conv.py``. Activations are
``[B, C, T]`` (the layout ``torch.nn.functional.conv1d`` takes); parameters
keep the names of the JAX tree (``v``, ``g``, ``b``) in torch layouts:

- ``NormConv1d.v`` is ``(Cout, Cin // groups, K)``; weight norm is taken
  over dims (1, 2) per output channel;
- ``NormConvTranspose1d.v`` is ``(Cin, Cout // groups, K)``; weight norm is
  taken over dims (1, 2) per input channel;
- ``NormConv2d.v`` is ``(Cout, Cin // groups, Kh, Kw)`` over ``[B, C, H, W]``
  activations; weight norm is taken over dims (1, 2, 3).

Parameters are created empty: a module is filled from a checkpoint by
:mod:`waveverify_torch.weights`, or drawn by :func:`init_params` with the
JAX package's initialisers (kaiming-normal ``v`` with the fan of
``v.shape[1:]``, the torch rule for both conv kinds, gain sqrt(2) for convs
that feed a ReLU-like activation; ``g = ||v||``; zero biases).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int = 0) -> int:
    """Extra end padding so the conv sees complete windows. Uses the raw
    kernel size, not the dilated one, as the reference does."""
    if kernel_size <= 0 or stride <= 0:
        raise ValueError(
            f"kernel_size and stride must be positive, got {kernel_size}, {stride}")
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return max(0, ideal_length - length)


def pad1d(x: torch.Tensor, paddings: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad the last (time) axis (the shipped configs' ``pad_mode``
    is ``constant``; other modes are not ported)."""
    left, right = paddings
    if left < 0 or right < 0:
        raise ValueError(f"negative padding: {paddings}")
    return F.pad(x, (left, right))


def unpad1d(x: torch.Tensor, paddings: Tuple[int, int]) -> torch.Tensor:
    """Remove padding from the last (time) axis."""
    left, right = paddings
    if left < 0 or right < 0:
        raise ValueError(f"negative padding: {paddings}")
    if left + right > x.shape[-1]:
        raise ValueError("padding exceeds tensor length")
    return x[..., left:x.shape[-1] - right]


def _kaiming_normal_std(fan_in: int, nonlinearity: str) -> float:
    gain = math.sqrt(2.0) if nonlinearity == "relu" else 1.0
    return gain / math.sqrt(max(fan_in, 1))


def init_params(root: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter under ``root`` from ``generator`` (a CPU
    ``torch.Generator``), in module order: each module that owns
    parameters initialises them in its ``init_weights``."""
    with torch.no_grad():
        for m in root.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(generator)


def _normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=generator) * std)


def trunc_normal_(p: torch.Tensor, std: float,
                  generator: torch.Generator) -> None:
    """Normal(0, std) truncated at +-2 std, as flax's ``truncated_normal``
    (``torch.nn.init.trunc_normal_`` bounds are absolute)."""
    p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), std=std, a=-2 * std,
                                  b=2 * std, generator=generator))


class _WeightNormConv(nn.Module):
    """``v``, weight-norm ``g`` over dims 1.. of ``v`` and bias ``b``."""

    def init_weights(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.v.shape[1:])
        _normal_(self.v, _kaiming_normal_std(fan_in, self.nonlinearity),
                 generator)
        if self.g is not None:
            self.g.copy_(torch.sqrt(torch.sum(
                self.v * self.v, dim=tuple(range(1, self.v.dim())))))
        if self.b is not None:
            self.b.zero_()

    def weight(self) -> torch.Tensor:
        """The effective f32 kernel: ``g * v / ||v||`` per leading index."""
        if self.g is None:
            return self.v
        dims = tuple(range(1, self.v.dim()))
        norm_v = torch.sqrt(torch.sum(self.v * self.v, dim=dims, keepdim=True))
        return self.v * (self.g.view((-1,) + (1,) * len(dims)) / norm_v)


def _check_norm(norm: str) -> None:
    if norm not in ("weight_norm", "none"):
        raise NotImplementedError(
            f"norm {norm!r} is not ported (the shipped configs use "
            "weight_norm, and the detector head none)")


class NormConv1d(_WeightNormConv):
    """Conv1d with optional weight norm; ``w = g * v / ||v||``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, norm: str = "none",
                 nonlinearity: str = "linear"):
        super().__init__()
        _check_norm(norm)
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.kernel_size, self.norm = kernel_size, norm
        self.nonlinearity = nonlinearity
        self.v = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                          kernel_size))
        self.g = (nn.Parameter(torch.empty(out_channels))
                  if norm == "weight_norm" else None)
        self.b = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x, self.weight().to(x.dtype), None, stride=self.stride,
                     dilation=self.dilation, groups=self.groups)
        if self.b is not None:
            y = y + self.b.to(y.dtype)[:, None]
        return y


class NormConvTranspose1d(_WeightNormConv):
    """ConvTranspose1d (padding 0) with optional weight norm over
    (Cout // groups, K) per input channel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, norm: str = "none",
                 nonlinearity: str = "linear"):
        super().__init__()
        _check_norm(norm)
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.kernel_size, self.norm = kernel_size, norm
        self.nonlinearity = nonlinearity
        self.v = nn.Parameter(torch.empty(in_channels, out_channels // groups,
                                          kernel_size))
        self.g = (nn.Parameter(torch.empty(in_channels))
                  if norm == "weight_norm" else None)
        self.b = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x, self.weight().to(x.dtype), None,
                               stride=self.stride, groups=self.groups,
                               dilation=self.dilation)
        if self.b is not None:
            y = y + self.b.to(y.dtype)[:, None]
        return y


class NormConv2d(_WeightNormConv):
    """Conv2d over ``[B, C, H, W]`` with torch-style symmetric ``padding``
    and optional weight norm over (Cin // groups, Kh, Kw) per output
    channel (the discriminator's convs)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0), groups: int = 1,
                 use_bias: bool = True, norm: str = "none",
                 nonlinearity: str = "linear"):
        super().__init__()
        _check_norm(norm)
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.stride, self.padding, self.groups = tuple(stride), tuple(padding), groups
        self.norm, self.nonlinearity = norm, nonlinearity
        self.v = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                          *kernel_size))
        self.g = (nn.Parameter(torch.empty(out_channels))
                  if norm == "weight_norm" else None)
        self.b = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight().to(x.dtype),
                        None if self.b is None else self.b.to(x.dtype),
                        stride=self.stride, padding=self.padding,
                        groups=self.groups)


class SConv1d(nn.Module):
    """Conv1d with causal (all left) or centred padding plus the extra right
    padding that keeps ``out_length == ceil(in_length / stride)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, causal: bool = False,
                 norm: str = "none", nonlinearity: str = "linear"):
        super().__init__()
        self.causal = causal
        self.conv = NormConv1d(in_channels, out_channels, kernel_size,
                               stride=stride, dilation=dilation, groups=groups,
                               use_bias=use_bias, norm=norm,
                               nonlinearity=nonlinearity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.conv.kernel_size, self.conv.stride, self.conv.dilation
        padding_total = (k - 1) * d - (s - 1)
        extra = get_extra_padding_for_conv1d(x.shape[-1], k, s, padding_total)
        if self.causal:
            x = pad1d(x, (padding_total, extra))
        else:
            right = padding_total // 2
            x = pad1d(x, (padding_total - right, right + extra))
        return self.conv(x)


class SConvTranspose1d(nn.Module):
    """ConvTranspose1d that trims ``kernel_size - stride`` samples of
    padding, from the right per ``trim_right_ratio`` when causal."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, causal: bool = False,
                 norm: str = "none", trim_right_ratio: float = 1.0,
                 nonlinearity: str = "linear"):
        super().__init__()
        if not causal and trim_right_ratio != 1.0:
            raise ValueError("trim_right_ratio != 1.0 requires causal=True")
        if not 0.0 <= trim_right_ratio <= 1.0:
            raise ValueError("trim_right_ratio must be in [0, 1]")
        self.causal, self.trim_right_ratio = causal, trim_right_ratio
        self.convtr = NormConvTranspose1d(
            in_channels, out_channels, kernel_size, stride=stride,
            dilation=dilation, groups=groups, use_bias=use_bias, norm=norm,
            nonlinearity=nonlinearity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convtr(x)
        padding_total = self.convtr.kernel_size - self.convtr.stride
        if self.causal:
            right = math.ceil(padding_total * self.trim_right_ratio)
        else:
            right = padding_total // 2
        return unpad1d(y, (padding_total - right, right))


def dft_basis(n_fft: int, win_size: Optional[int] = None,
              win_type: Optional[str] = "hann",
              norm: Optional[str] = "backward") -> np.ndarray:
    """Windowed DFT basis ``(n_fft, 1, 2 * (n_fft // 2 + 1))`` in the JAX
    package's WIO layout, built with the same f32 numpy arithmetic (the f32
    rounding of the angle itself matters at large n_fft)."""
    if win_size is None:
        win_size = n_fft
    if win_type == "hann":
        nw = np.arange(win_size, dtype=np.float32)
        window = (
            np.float32(0.5)
            - np.float32(0.5)
            * np.cos(np.float32(2.0 * np.pi / win_size) * nw, dtype=np.float32)
        ).astype(np.float32)
    elif win_type is None:
        window = np.ones(win_size, dtype=np.float32)
    else:
        raise ValueError(f"unknown window type {win_type}")
    if win_size < n_fft:
        padding = n_fft - win_size
        window = np.pad(window, (padding // 2, padding - padding // 2))
    n = np.arange(n_fft, dtype=np.float32)[None, :]
    k_ = np.arange(n_fft // 2 + 1, dtype=np.float32)[:, None]
    s = np.float32(-2.0 * math.pi / n_fft)
    ang = ((s * k_).astype(np.float32) * n).astype(np.float32)
    weight = np.concatenate(
        [np.cos(ang, dtype=np.float32), np.sin(ang, dtype=np.float32)], axis=0
    ) * window[None, :]
    if norm == "forward":
        weight = weight / np.float32(n_fft)
    elif norm == "ortho":
        weight = weight / np.float32(math.sqrt(n_fft))
    return np.transpose(weight, (1, 0))[:, None, :].astype(np.float32)


class CausalSTFT(nn.Module):
    """Magnitude STFT as a strided conv, left-padded ``n_fft - 1`` samples.

    Input ``[B, 1, T]``; output ``[B, n_fft // 2 + 1, n_frames]``. The basis
    is a constant buffer, not a parameter."""

    def __init__(self, n_fft: int, hop_size: int, eps: float = 1e-12):
        super().__init__()
        self.n_fft, self.hop_size, self.eps = n_fft, hop_size, eps
        basis = np.transpose(dft_basis(n_fft), (2, 1, 0))  # (2F, 1, n_fft)
        self.register_buffer("basis", torch.from_numpy(basis.copy()),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad1d(x, (self.n_fft - 1, 0))
        spec = F.conv1d(x, self.basis.to(x.dtype), stride=self.hop_size)
        f = self.n_fft // 2 + 1
        re, im = spec[:, :f], spec[:, f:]
        return torch.sqrt(torch.clamp(re * re + im * im, min=self.eps))


def fused_upsample_head(rc: NormConvTranspose1d, ll: NormConv1d,
                        z: torch.Tensor, original_length: int) -> torch.Tensor:
    """Detector head: ConvTranspose1d (k == stride, no norm), trim, then a
    1x1 conv, as one matmul against the precontracted kernels
    ``wc[c, kappa, n] = sum_m w1[c, m, kappa] * w2[m, n]``.

    z ``[B, Cin, T']`` -> logits ``[B, T, Cout]`` (time-major, the JAX
    package's public logits layout)."""
    if (rc.norm != "none" or ll.norm != "none" or rc.kernel_size != rc.stride
            or rc.groups != 1 or ll.kernel_size != 1):
        raise ValueError("the fused head needs an un-normalised k == stride "
                         "transposed conv and an un-normalised 1x1 conv")
    w1 = rc.v  # (Cin, Cmid, K)
    w2 = ll.v[:, :, 0].t()  # (Cmid, Cout)
    cin, _cmid, k = w1.shape
    cout = w2.shape[-1]
    wc = torch.einsum("cmk,mn->ckn", w1, w2).reshape(cin, k * cout)
    y = torch.matmul(z.transpose(1, 2), wc.to(z.dtype)).reshape(
        z.shape[0], z.shape[-1] * k, cout)
    bias = torch.zeros((cout,), dtype=z.dtype, device=z.device)
    if ll.b is not None:
        bias = bias + ll.b.to(z.dtype)
    if rc.b is not None:
        bias = bias + (rc.b @ w2).to(z.dtype)
    return y[:, :original_length] + bias
