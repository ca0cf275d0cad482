"""Smart-padded convolutions with the conv normalisations, in PyTorch.

Counterpart of ``waveverify_tpu/modules/conv.py``. Activations are
``[B, C, T]`` (the layout ``torch.nn.functional.conv1d`` takes); parameters
keep the names of the JAX tree (``v``, ``g``, ``b``) in torch layouts:

- ``NormConv1d.v`` is ``(Cout, Cin // groups, K)``; weight norm is taken
  over dims (1, 2) per output channel;
- ``NormConvTranspose1d.v`` is ``(Cin, Cout // groups, K)``; weight norm is
  taken over dims (1, 2) per input channel;
- ``NormConv2d.v`` is ``(Cout, Cin // groups, Kh, Kw)`` over ``[B, C, H, W]``
  activations; weight norm is taken over dims (1, 2, 3);
- ``NormConvTranspose2d.v`` is ``(Cin, Cout // groups, Kh, Kw)``, as in JAX.

The normalisations are the JAX package's (``CONV_NORMALIZATIONS``):
``weight_norm`` (``w = g * v / ||v||``); ``weight_standardization``
(``w = g * (v - mean) * rsqrt(max(var * fan_in, eps))`` with the population
variance over the same dims, ``g`` in the JAX shape: ``(1, 1, C)`` for a
1-D conv, ``(Cin, 1, 1)`` for a transposed one); ``spectral_norm`` (``v``
over its largest singular value, by a fixed 9-step power iteration from a
constant start vector, as JAX computes it, not torch's stateful
``spectral_norm``); ``layer_norm`` and ``time_group_norm`` (a plain kernel,
then :class:`ConvLayerNorm` or a one-group :class:`GroupNorm` under a
``norm`` submodule). The transposed and 2-D convs refuse what JAX's refuse.

Parameters are created empty: a module is filled from a checkpoint by
:mod:`waveverify_torch.weights`, or drawn by :func:`init_params` with the
JAX package's initialisers (kaiming-normal ``v`` with the fan of
``v.shape[1:]``, the torch rule for both conv kinds, gain sqrt(2) for convs
that feed a ReLU-like activation; ``g = ||v||`` under weight norm, ones
under weight standardization; zero biases; norm scales one, biases zero).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CONV_NORMALIZATIONS = frozenset([
    "none", "weight_norm", "spectral_norm", "weight_standardization",
    "time_layer_norm", "layer_norm", "time_group_norm"])


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


def pad1d(x: torch.Tensor, paddings: Tuple[int, int],
          mode: str = "constant") -> torch.Tensor:
    """Pad the last (time) axis: ``constant`` (zeros), ``reflect``,
    ``replicate`` (edge) or ``circular`` (wrap). Reflect padding of an input
    no longer than the pad first zero-extends it so the reflection is
    defined, then drops the extension, as the JAX package does."""
    left, right = paddings
    if left < 0 or right < 0:
        raise ValueError(f"negative padding: {paddings}")
    if mode == "constant":
        return F.pad(x, (left, right))
    extra = 0
    if mode == "reflect" and x.shape[-1] <= max(left, right):
        extra = max(left, right) - x.shape[-1] + 1
        x = F.pad(x, (0, extra))
    n = x.shape[-1]
    idx = torch.arange(-left, n + right, device=x.device)
    if mode == "reflect":
        idx = torch.where(idx < 0, -idx, idx)
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    elif mode == "replicate":
        idx = idx.clamp(0, n - 1)
    elif mode == "circular":
        idx = idx % n
    else:
        raise ValueError(f"unknown pad mode: {mode}")
    out = x.index_select(-1, idx)
    return out[..., :out.shape[-1] - extra] if extra else out


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


def _mean_var(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's statistics: ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)``."""
    mean = x.mean(dim=dims, keepdim=True)
    var = (x * x).mean(dim=dims, keepdim=True) - mean * mean
    return mean, torch.maximum(var, var.new_zeros(()))


class _ScaleBias(nn.Module):
    """A per-channel ``scale`` (ones) and ``bias`` (zeros) over dim 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def init_weights(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def _affine(self, y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                eps: float) -> torch.Tensor:
        shape = (1, -1) + (1,) * (y.dim() - 2)
        mul = torch.rsqrt(var + eps) * self.scale.view(shape)
        return (y - mean) * mul + self.bias.view(shape)


class LayerNorm(_ScaleBias):
    """flax ``LayerNorm`` over the channels (dim 1)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float()
        mean, var = _mean_var(y, (1,))
        return self._affine(y, mean, var, self.eps).to(x.dtype)


class GroupNorm(_ScaleBias):
    """flax ``GroupNorm(num_groups=1)``: one group over every channel and
    time step of an item, eps 1e-6 (torch's default is 1e-5)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float()
        mean, var = _mean_var(y, tuple(range(1, y.dim())))
        return self._affine(y, mean, var, self.eps).to(x.dtype)


class ConvLayerNorm(nn.Module):
    """LayerNorm over the channels of conv features, eps 1e-5; its
    parameters sit under ``LayerNorm_0`` as in the flax tree."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(x)


def _spectral_sigma(w2d: torch.Tensor, n_iters: int = 9) -> torch.Tensor:
    """Largest singular value of ``w2d [rows, cols]`` by ``n_iters`` power
    iterations from the constant vector, differentiable throughout."""
    u = torch.full((w2d.shape[0],), 1.0 / math.sqrt(w2d.shape[0]),
                   dtype=w2d.dtype, device=w2d.device)
    for _ in range(n_iters):
        vv = w2d.t() @ u
        vv = vv / (torch.linalg.vector_norm(vv) + 1e-12)
        uu = w2d @ vv
        u = uu / (torch.linalg.vector_norm(uu) + 1e-12)
    sigma = torch.linalg.vector_norm(w2d.t() @ u)
    return torch.maximum(sigma, sigma.new_tensor(1e-12))


class _NormConv(nn.Module):
    """``v``, the normalisation's ``g``, bias ``b`` and the ``norm``
    submodule (None but under layer_norm and time_group_norm; the
    normalisation's name is ``norm_type``). The normalisation keeps dim 0
    of ``v``: the output channels of a conv, the input channels of a
    transposed conv; weight standardization's ``g`` has JAX's shape, the
    kept channels last for a conv and first for a transposed conv."""

    _transposed = False

    def _setup(self, norm: str, norm_kwargs: Optional[dict], vshape: Tuple[int, ...],
               out_channels: int, use_bias: bool, nonlinearity: str,
               allowed: Tuple[str, ...], refusal: str) -> None:
        if norm not in CONV_NORMALIZATIONS:
            raise ValueError(f"invalid norm: {norm}")
        if norm not in allowed:
            raise NotImplementedError(refusal.format(norm=norm))
        self.norm_type, self.nonlinearity = norm, nonlinearity
        self.eps = (norm_kwargs or {}).get("eps", 1e-7)
        self.v = nn.Parameter(torch.empty(vshape))
        lead = vshape[0]
        if norm == "weight_norm":
            self.g = nn.Parameter(torch.empty(lead))
        elif norm == "weight_standardization":
            gshape = [1] * len(vshape)
            gshape[0 if self._transposed else -1] = lead
            self.g = nn.Parameter(torch.empty(gshape))
        else:
            self.g = None
        self.b = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        # the flax tree's ``norm`` module, after the conv
        if norm == "layer_norm":
            self.norm = ConvLayerNorm(out_channels)
        elif norm == "time_group_norm":
            self.norm = GroupNorm(out_channels)
        else:
            self.norm = None

    def _norm_dims(self) -> Tuple[int, ...]:
        return tuple(range(1, self.v.dim()))

    def init_weights(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.v.shape[1:])
        _normal_(self.v, _kaiming_normal_std(fan_in, self.nonlinearity),
                 generator)
        if self.norm_type == "weight_norm":
            self.g.copy_(torch.sqrt(torch.sum(self.v * self.v,
                                              dim=self._norm_dims())))
        elif self.norm_type == "weight_standardization":
            self.g.fill_(1.0)
        if self.b is not None:
            self.b.zero_()

    def _lead_view(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape((-1,) + (1,) * (self.v.dim() - 1))

    def weight(self) -> torch.Tensor:
        """The effective f32 kernel in ``v``'s layout."""
        v, dims = self.v, self._norm_dims()
        if self.norm_type == "weight_norm":
            norm_v = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
            return v * (self._lead_view(self.g) / norm_v)
        if self.norm_type == "weight_standardization":
            fan_in = math.prod(v.shape[d] for d in dims)
            mean = v.mean(dim=dims, keepdim=True)
            var = v.var(dim=dims, keepdim=True, correction=0)
            return self._lead_view(self.g) * ((v - mean) * torch.rsqrt(
                torch.maximum(var * float(fan_in), var.new_tensor(self.eps))))
        if self.norm_type == "spectral_norm":
            # JAX's v.reshape(-1, Cout) of its (K, Cin / g, Cout) kernel
            w2d = v.permute(*reversed(range(v.dim()))).reshape(-1, v.shape[0])
            return v / _spectral_sigma(w2d)
        return v

    def _finish(self, y: torch.Tensor) -> torch.Tensor:
        """Bias, then the norm module."""
        if self.b is not None:
            y = y + self.b.to(y.dtype).view((1, -1) + (1,) * (y.dim() - 2))
        if self.norm is not None:
            y = self.norm(y)
        return y


class NormConv1d(_NormConv):
    """Conv1d with any of the JAX package's normalisations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, norm: str = "none",
                 nonlinearity: str = "linear", norm_kwargs: Optional[dict] = None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.kernel_size = kernel_size
        self._setup(norm, norm_kwargs, (out_channels, in_channels // groups,
                                        kernel_size), out_channels, use_bias,
                    nonlinearity,
                    ("none", "weight_norm", "weight_standardization",
                     "spectral_norm", "layer_norm", "time_group_norm"),
                    "norm '{norm}' is not supported in the TPU build (the "
                    "reference config only exercises weight_norm / "
                    "weight_standardization / none)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x, self.weight().to(x.dtype), None, stride=self.stride,
                     dilation=self.dilation, groups=self.groups)
        return self._finish(y)


class NormConvTranspose1d(_NormConv):
    """ConvTranspose1d (padding 0); the normalisation is taken over
    (Cout // groups, K) per input channel. Spectral norm is refused, as in
    JAX."""

    _transposed = True

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, norm: str = "none",
                 nonlinearity: str = "linear", norm_kwargs: Optional[dict] = None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.kernel_size = kernel_size
        self._setup(norm, norm_kwargs, (in_channels, out_channels // groups,
                                        kernel_size), out_channels, use_bias,
                    nonlinearity,
                    ("none", "weight_norm", "weight_standardization",
                     "layer_norm", "time_group_norm"),
                    "norm '{norm}' unsupported")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x, self.weight().to(x.dtype), None,
                               stride=self.stride, groups=self.groups,
                               dilation=self.dilation)
        return self._finish(y)


class NormConv2d(_NormConv):
    """Conv2d over ``[B, C, H, W]`` with torch-style symmetric ``padding``;
    weight norm, weight standardization or none (the discriminator's
    convs)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0), groups: int = 1,
                 use_bias: bool = True, norm: str = "none",
                 nonlinearity: str = "linear", norm_kwargs: Optional[dict] = None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.stride, self.padding, self.groups = tuple(stride), tuple(padding), groups
        self._setup(norm, norm_kwargs, (out_channels, in_channels // groups,
                                        *kernel_size), out_channels, use_bias,
                    nonlinearity,
                    ("none", "weight_norm", "weight_standardization"),
                    "norm '{norm}' unsupported for 2d")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight().to(x.dtype),
                        None if self.b is None else self.b.to(x.dtype),
                        stride=self.stride, padding=self.padding,
                        groups=self.groups)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int],
                     groups: int = 1, dilation: Tuple[int, int] = (1, 1)
                     ) -> torch.Tensor:
    """ConvTranspose2d with padding 0 over ``[B, Cin, H, W]``; ``w`` is
    ``(Cin, Cout // groups, Kh, Kw)``. Output size per dim ``(L - 1) *
    stride + dilation * (K - 1) + 1``."""
    return F.conv_transpose2d(x, w, None, stride=tuple(stride), groups=groups,
                              dilation=tuple(dilation))


class NormConvTranspose2d(_NormConv):
    """ConvTranspose2d over ``[B, C, H, W]``: weight norm over (Cout //
    groups, Kh, Kw) per input channel, weight standardization or none.
    ``padding`` / ``output_padding`` crop the padding-0 output as the JAX
    package does (``y[:, :, ph:h - ph + oph, pw:w - pw + opw]``), then the
    bias is added."""

    _transposed = True

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0),
                 output_padding: Tuple[int, int] = (0, 0),
                 dilation: Tuple[int, int] = (1, 1), groups: int = 1,
                 use_bias: bool = True, norm: str = "none",
                 nonlinearity: str = "linear", norm_kwargs: Optional[dict] = None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.stride, self.dilation, self.groups = tuple(stride), tuple(dilation), groups
        self.padding, self.output_padding = tuple(padding), tuple(output_padding)
        self._setup(norm, norm_kwargs, (in_channels, out_channels // groups,
                                        *kernel_size), out_channels, use_bias,
                    nonlinearity,
                    ("none", "weight_norm", "weight_standardization"),
                    "norm '{norm}' unsupported for 2d")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_transpose2d(x, self.weight().to(x.dtype), self.stride,
                             self.groups, self.dilation)
        (ph, pw), (oph, opw) = self.padding, self.output_padding
        if ph or pw or oph or opw:
            h, w = y.shape[2], y.shape[3]
            y = y[:, :, ph:h - ph + oph, pw:w - pw + opw]
        return self._finish(y)


class SConv1d(nn.Module):
    """Conv1d with causal (all left) or centred padding plus the extra right
    padding that keeps ``out_length == ceil(in_length / stride)``, padded
    per ``pad_mode``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, causal: bool = False,
                 norm: str = "none", nonlinearity: str = "linear",
                 pad_mode: str = "constant"):
        super().__init__()
        self.causal, self.pad_mode = causal, pad_mode
        self.conv = NormConv1d(in_channels, out_channels, kernel_size,
                               stride=stride, dilation=dilation, groups=groups,
                               use_bias=use_bias, norm=norm,
                               nonlinearity=nonlinearity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.conv.kernel_size, self.conv.stride, self.conv.dilation
        padding_total = (k - 1) * d - (s - 1)
        extra = get_extra_padding_for_conv1d(x.shape[-1], k, s, padding_total)
        if self.causal:
            x = pad1d(x, (padding_total, extra), self.pad_mode)
        else:
            right = padding_total // 2
            x = pad1d(x, (padding_total - right, right + extra), self.pad_mode)
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
    """Magnitude STFT as a strided conv, left-padded ``n_fft - 1`` samples
    per ``pad_mode``.

    Input ``[B, 1, T]``; output ``[B, n_fft // 2 + 1, n_frames]``. The basis
    ``(2F, 1, n_fft)`` is a constant buffer, or with ``learnable`` the
    parameter ``weight`` (the JAX leaf ``stft/weight``), initialised to the
    same basis."""

    def __init__(self, n_fft: int, hop_size: int, eps: float = 1e-12,
                 pad_mode: str = "constant", learnable: bool = False):
        super().__init__()
        self.n_fft, self.hop_size, self.eps = n_fft, hop_size, eps
        self.pad_mode, self.learnable = pad_mode, learnable
        basis = torch.from_numpy(np.ascontiguousarray(
            np.transpose(dft_basis(n_fft), (2, 1, 0))))  # (2F, 1, n_fft)
        if learnable:
            self.weight = nn.Parameter(basis.clone())
        else:
            self.register_buffer("basis", basis, persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        if self.learnable:
            self.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                np.transpose(dft_basis(self.n_fft), (2, 1, 0)))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        basis = self.weight if self.learnable else self.basis
        x = pad1d(x, (self.n_fft - 1, 0), self.pad_mode)
        spec = F.conv1d(x, basis.to(x.dtype), stride=self.hop_size)
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
    if (rc.norm_type != "none" or ll.norm_type != "none" or rc.kernel_size != rc.stride
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
