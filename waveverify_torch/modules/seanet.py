"""SEANet encoder/decoder with FiLM message conditioning, in PyTorch.

Counterpart of ``waveverify_tpu/modules/seanet.py``; activations are
``[B, C, T]``. Submodule and parameter names follow the JAX parameter tree
(``block_0_1/block_0_pw/conv/v`` is ``block_0_1.block_0_pw.conv.v``), so a
checkpoint maps onto the modules by path (:mod:`waveverify_torch.weights`).

Runs of residual blocks go through :func:`_apply_resblock_chain`, which
hands a whole chain to the fused kernel when its blocks have the kernel's
shape (identity skip, causal, dilations (1, 1), a kernel size it takes).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from waveverify_torch.modules.conv import (
    CausalSTFT,
    SConv1d,
    SConvTranspose1d,
    trunc_normal_,
)
from waveverify_torch.ops.resblock_chain import (
    KERNEL_SIZES,
    MAX_CHANNELS,
    fused_resblock_chain,
    stack_chain_weights,
)

DEFAULT_SPEC_MEANS = (-4.554, -4.315, -4.021, -3.726, -3.477)
DEFAULT_SPEC_STDS = (2.830, 2.837, 2.817, 2.796, 2.871)
DEFAULT_WAV_STD = 0.1122080159


def get_activation(name: str, alpha: float = 1.0) -> Callable:
    """The activations the shipped configs use."""
    if name == "ELU":
        return lambda x: F.elu(x, alpha=alpha)
    if name == "Tanh":
        return torch.tanh
    raise NotImplementedError(f"activation {name!r} is not ported")


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation scaled by sqrt(C)."""

    def __init__(self, inout_norm: bool = True, eps: float = 1e-12):
        super().__init__()
        self.inout_norm, self.eps = inout_norm, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        y = x / torch.clamp(norm, min=self.eps)
        if self.inout_norm:
            y = y * (x.shape[1] ** 0.5)
        return y


class FiLM(nn.Module):
    """Feature-wise linear modulation of one channel band. gamma and beta
    are computed in f32 and cast to the stream dtype at the modulation.
    ``gamma_bias`` is the gamma layer's initial bias."""

    def __init__(self, embedding_dim: int, gamma_bias: float = 0.0):
        super().__init__()
        self.gamma = nn.Linear(embedding_dim, 1)
        self.beta = nn.Linear(embedding_dim, 1)
        self.gamma_bias = gamma_bias

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.gamma, self.beta):
            trunc_normal_(layer.weight, 0.02, generator)
        self.gamma.bias.fill_(self.gamma_bias)
        self.beta.bias.zero_()

    def forward(self, x: torch.Tensor, condition: torch.Tensor,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        gamma = self.gamma(condition)
        beta = self.beta(condition)
        if offsets is not None:
            gamma = gamma + offsets[:, 0:1]
            beta = beta + offsets[:, 1:2]
        gamma = gamma.to(x.dtype)
        beta = beta.to(x.dtype)
        return x * gamma[:, :, None] + beta[:, :, None]


def _film_carrier(nbits: int, n_sites: int) -> np.ndarray:
    """Fixed orthonormal per-bit signatures over the FiLM (gamma, beta)
    slots, ``[nbits, 2 * n_sites]``: Sylvester-Hadamard rows (skipping the
    all-ones row) when the slot count is a power of two >= nbits + 1,
    else a fixed QR basis."""
    slots = 2 * n_sites
    if slots >= nbits + 1 and slots & (slots - 1) == 0:
        h = np.ones((1, 1), np.float64)
        while h.shape[0] < slots:
            h = np.block([[h, h], [h, -h]])
        sig = h[1:nbits + 1] / np.sqrt(slots)
    else:
        rs = np.random.RandomState(17)
        q = np.linalg.qr(rs.randn(max(slots, nbits), nbits))[0]
        sig = q[:slots].T
        norms = np.linalg.norm(sig, axis=1, keepdims=True)
        sig = sig / np.maximum(norms, 1e-8)
    return sig.astype(np.float32)


def _check_ported(skip: str, act_all: bool, expansion: int, groups: int,
                  zero_init: bool, pad_mode: str) -> None:
    """The port builds the shipped configs' shape: identity-skip blocks with
    one activation per branch and depthwise convs, no learned residual
    gates, zero padding."""
    got = (skip, act_all, expansion, groups, zero_init, pad_mode)
    if got != ("identity", False, 1, -1, False, "constant"):
        raise NotImplementedError(
            "not ported: (skip, act_all, expansion, groups, zero_init, "
            f"pad_mode) = {got}")


class SEANetResnetBlock(nn.Module):
    """Residual block: (act -> 1x1 -> causal depthwise k) twice, with
    progressive pre-scaling ``(1 + idx * res_scale^2)^-0.5`` and an
    identity skip."""

    def __init__(self, dim: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 1), activation: str = "ELU",
                 alpha: float = 1.0, norm: str = "weight_norm",
                 causal: bool = True, use_bias: bool = True,
                 res_scale: Optional[float] = None, idx: int = 0):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.activation, self.alpha, self.causal = activation, alpha, causal
        self.res_scale, self.idx = res_scale, idx
        self.act = get_activation(activation, alpha)
        # (key, weights) of the chain this block heads; see _chain_weights
        self._chain_cache = None
        for i, d in enumerate(self.dilations):
            setattr(self, f"block_{i}_pw", SConv1d(dim, dim, 1, norm=norm,
                                                   use_bias=False,
                                                   nonlinearity="relu"))
            setattr(self, f"block_{i}_dw", SConv1d(
                dim, dim, kernel_size, dilation=d, groups=dim, norm=norm,
                causal=causal, use_bias=use_bias))

    @property
    def prescale(self) -> float:
        if self.res_scale is None:
            return 1.0
        return (1.0 + self.idx * self.res_scale**2) ** -0.5

    def fusable(self) -> bool:
        """Whether the block has the fused kernel's shape."""
        return (self.activation == "ELU" and self.causal
                and self.dilations == (1, 1)
                and self.kernel_size in KERNEL_SIZES)

    def fused_params(self) -> list:
        """``[(pw [Cin, Cout], dw [k, C], b [C])] * 2`` with weight norm
        applied, in the kernel's orientation."""
        out = []
        for i in range(2):
            pw = getattr(self, f"block_{i}_pw").conv
            dw = getattr(self, f"block_{i}_dw").conv
            w_dw = dw.weight()[:, 0, :].t()
            b = dw.b if dw.b is not None else torch.zeros_like(w_dw[0])
            out.append((pw.weight()[:, :, 0].t(), w_dw, b))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x * self.prescale if self.res_scale is not None else x
        for i in range(len(self.dilations)):
            y = getattr(self, f"block_{i}_pw")(self.act(y))
            y = getattr(self, f"block_{i}_dw")(y)
        scale = 1.0 if self.res_scale is None else self.res_scale
        return y * scale + x


def _chain_weights(blocks: Sequence[SEANetResnetBlock],
                   dtype: torch.dtype) -> list:
    """The chain's stacked kernel weights (weight norm applied, rounded to
    ``dtype``). A call that records gradients builds them from the
    parameters; any other call reuses the copy kept on the first block
    until a parameter is replaced or written in place."""
    params = [p for m in blocks for p in m.parameters()]

    def build() -> list:
        return stack_chain_weights(
            [fp[0] + fp[1] for fp in (m.fused_params() for m in blocks)], dtype)

    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return build()
    key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
    if blocks[0]._chain_cache is None or blocks[0]._chain_cache[0] != key:
        blocks[0]._chain_cache = (key, build())
    return blocks[0]._chain_cache[1]


def _apply_resblock_chain(blocks: Sequence[SEANetResnetBlock],
                          x: torch.Tensor) -> torch.Tensor:
    """Apply adjacent residual blocks: as one fused chain when every block
    has the kernel's shape and the chain is at most ``MAX_CHANNELS`` wide,
    else block by block in plain PyTorch (the JAX package's gate,
    ``can_fuse``, sends chains over 768 channels to XLA the same way). Other
    limits of the kernel (dtype) raise in its wrapper, they do not pick a
    path."""
    b0 = blocks[0] if blocks else None
    if b0 is not None and x.shape[1] <= MAX_CHANNELS and all(
            m.fusable() and m.kernel_size == b0.kernel_size
            and m.res_scale == b0.res_scale and m.alpha == b0.alpha
            for m in blocks):
        return fused_resblock_chain(
            x, _chain_weights(blocks, x.dtype),
            prescales=tuple(m.prescale for m in blocks),
            res_scale=b0.res_scale if b0.res_scale is not None else 1.0,
            alpha=b0.alpha)
    for m in blocks:
        x = m(x)
    return x


class SpecBlock(nn.Module):
    """Residual injection of normalised log-STFT features of the raw
    waveform, computed at this scale's cumulative stride."""

    def __init__(self, spec: str, spec_compression: str, n_fft: int,
                 channels: int, stride: int, norm: str = "weight_norm",
                 mean: float = 0.0, std: float = 1.0,
                 res_scale: Optional[float] = 1.0, inout_norm: bool = True):
        super().__init__()
        if spec not in ("", "stft"):
            raise ValueError(f"unknown spec type: {spec}")
        if spec_compression not in ("", "log"):
            raise NotImplementedError(
                f"spec_compression {spec_compression!r} is not ported")
        self.spec, self.spec_compression = spec, spec_compression
        self.mean, self.std, self.inout_norm = mean, std, inout_norm
        self.res_scale = res_scale
        if spec == "stft":
            self.stft = CausalSTFT(n_fft, stride)
            self.proj = SConv1d(n_fft // 2 + 1, channels, 1, norm=norm,
                                use_bias=False)

    def forward(self, x: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
        if self.spec == "":
            return x
        y = self.stft(wav)
        if self.spec_compression == "log":
            y = torch.log(torch.clamp(y, min=1e-5))
        if self.inout_norm:
            y = (y - self.mean) / self.std
        y = self.proj(y)
        scale = 1.0 if self.res_scale is None else self.res_scale
        return x + y * scale


class _ProjConv(nn.Module):
    """1x1 projection with its own bias parameter ``b``, drawn from N(0, 1)
    when ``normal_bias`` (the encoder's l2norm case), else zero."""

    def __init__(self, in_channels: int, out_channels: int, norm: str,
                 use_bias: bool, normal_bias: bool = False):
        super().__init__()
        self.conv = SConv1d(in_channels, out_channels, 1, norm=norm,
                            use_bias=False)
        self.b = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.normal_bias = normal_bias

    def init_weights(self, generator: torch.Generator) -> None:
        if self.b is not None:
            self.b.copy_(torch.randn(self.b.shape, generator=generator)
                         if self.normal_bias else torch.zeros(self.b.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.b is not None:
            y = y + self.b.to(y.dtype)[:, None]
        return y


class SEANetEncoder(nn.Module):
    """SEANet encoder with FiLM message modulation over frequency bands.

    Input audio ``[B, channels, T]`` and message ``[B, msg_dimension]`` or
    None; output latent ``[B, dimension, ceil(T / prod(ratios))]``."""

    def __init__(self, channels: int = 1, dimension: int = 128,
                 msg_dimension: int = 16, n_filters: int = 32,
                 n_fft_base: int = 64, n_residual_layers: int = 1,
                 ratios: Sequence[int] = (8, 5, 4, 2), activation: str = "ELU",
                 alpha: float = 1.0, norm: str = "weight_norm",
                 kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 skip: str = "identity", causal: bool = False,
                 pad_mode: str = "constant", act_all: bool = False,
                 expansion: int = 1, groups: int = -1, l2norm: bool = False,
                 use_bias: bool = True, spec: str = "stft",
                 spec_compression: str = "", res_scale: Optional[float] = None,
                 wav_std: float = DEFAULT_WAV_STD,
                 spec_means: Sequence[float] = DEFAULT_SPEC_MEANS,
                 spec_stds: Sequence[float] = DEFAULT_SPEC_STDS,
                 zero_init: bool = False, inout_norm: bool = True,
                 embedding_dim: int = 64, embedding_layers: int = 2,
                 freq_bands: int = 4, msg_mode: str = "reference",
                 msg_carrier_gain: float = 1.0, film_carrier_gain: float = 0.0,
                 film_gamma_bias: float = 0.0):
        super().__init__()
        _check_ported(skip, act_all, expansion, groups, zero_init, pad_mode)
        self.act = get_activation(activation, alpha)
        self.msg_dimension, self.embedding_dim = msg_dimension, embedding_dim
        self.embedding_layers, self.freq_bands = embedding_layers, freq_bands
        self.msg_mode, self.msg_carrier_gain = msg_mode, msg_carrier_gain
        self.film_carrier_gain = film_carrier_gain
        # fixed carriers, built once with the JAX package's numpy calls
        if msg_mode == "carrier":
            rs = np.random.RandomState(16)
            c = np.linalg.qr(rs.randn(embedding_dim, msg_dimension))[0]
            self.register_buffer("msg_carrier", torch.from_numpy(
                np.ascontiguousarray(c.astype(np.float32).T)), persistent=False)
        if film_carrier_gain > 0:
            self.register_buffer("film_carrier", torch.from_numpy(_film_carrier(
                msg_dimension, len(ratios) * freq_bands)), persistent=False)
        self.res_scale, self.n_residual_layers = res_scale, n_residual_layers
        self.wav_std, self.inout_norm, self.l2norm = wav_std, inout_norm, l2norm
        self.rev_ratios = list(reversed(list(ratios)))

        self.conv_pre = SConv1d(channels, n_filters, kernel_size, norm=norm,
                                causal=causal, use_bias=use_bias)
        self.msg_in = nn.Linear(msg_dimension, embedding_dim)
        for i in range(embedding_layers):
            setattr(self, f"msg_hidden_{i}", nn.Linear(embedding_dim, embedding_dim))

        mult, stride = 1, 1
        for block_idx, ratio in enumerate(self.rev_ratios):
            dim = mult * n_filters
            for j in range(1, n_residual_layers + 1):
                setattr(self, f"block_{block_idx}_{j - 1}", SEANetResnetBlock(
                    dim, kernel_size=residual_kernel_size,
                    dilations=(dilation_base**j, 1), activation=activation,
                    alpha=alpha, norm=norm, causal=causal, use_bias=use_bias,
                    res_scale=res_scale, idx=j - 1 if spec == "" else j))
            setattr(self, f"spec_block_{block_idx}", SpecBlock(
                spec, spec_compression, mult * n_fft_base, dim, stride,
                norm=norm, mean=spec_means[block_idx],
                std=spec_stds[block_idx], res_scale=res_scale,
                inout_norm=inout_norm))
            stride *= ratio
            setattr(self, f"down_{block_idx}_expand", SConv1d(
                dim, dim * 2, 1, norm=norm, use_bias=False, nonlinearity="relu"))
            setattr(self, f"down_{block_idx}_dw", SConv1d(
                dim * 2, dim * 2, ratio * 2, stride=ratio, groups=dim * 2,
                norm=norm, causal=causal, use_bias=use_bias))
            if (dim * 2) % freq_bands:
                raise ValueError(
                    f"channels ({dim * 2}) must be divisible by freq_bands "
                    f"({freq_bands}) at scale {block_idx}")
            for band_idx in range(freq_bands):
                setattr(self, f"film_{block_idx}_{band_idx}",
                        FiLM(embedding_dim, film_gamma_bias))
            mult *= 2
        self.spec_post = SpecBlock(
            spec, spec_compression, mult * n_fft_base, mult * n_filters, stride,
            norm=norm, mean=spec_means[-1], std=spec_stds[-1],
            res_scale=res_scale, inout_norm=inout_norm)
        self.post_dw = SConv1d(mult * n_filters, mult * n_filters,
                               last_kernel_size, groups=mult * n_filters,
                               norm=norm, causal=causal, use_bias=False,
                               nonlinearity="relu")
        # with l2norm the projection always has a bias (the reference would
        # dereference a missing one)
        self.post_proj = _ProjConv(mult * n_filters, dimension, norm,
                                   use_bias or l2norm, normal_bias=l2norm)
        self.l2norm_layer = L2Norm(inout_norm) if l2norm else None

    def init_weights(self, generator: torch.Generator) -> None:
        """The message MLP's Dense layers: truncated normal(0.02), zero
        bias."""
        for i in range(-1, self.embedding_layers):
            layer = getattr(self, "msg_in" if i < 0 else f"msg_hidden_{i}")
            trunc_normal_(layer.weight, 0.02, generator)
            layer.bias.zero_()

    def _msg_embed(self, msg: torch.Tensor) -> torch.Tensor:
        """Message MLP; in ``carrier`` mode on +/-1 bits plus the fixed
        orthonormal carrier ``msg_carrier`` (``RandomState(16)``)."""
        carrier = self.msg_mode == "carrier"
        m = msg.float()
        s = 2.0 * m - 1.0 if carrier else m
        h = self.msg_in(s)
        for i in range(self.embedding_layers):
            h = F.relu(getattr(self, f"msg_hidden_{i}")(h))
        if carrier:
            h = h + s @ self.msg_carrier * self.msg_carrier_gain
        return h

    def forward(self, x: torch.Tensor,
                msg: Optional[torch.Tensor] = None) -> torch.Tensor:
        wav = x
        if self.inout_norm:
            x = x * (1.0 / self.wav_std)
        x = self.conv_pre(x)
        cond, offsets = None, None
        if msg is not None:
            cond = self._msg_embed(msg)
            if self.film_carrier_gain > 0:
                s = 2.0 * msg.float() - 1.0
                offsets = (s @ self.film_carrier) * self.film_carrier_gain
        for block_idx, _ratio in enumerate(self.rev_ratios):
            x = _apply_resblock_chain(
                [getattr(self, f"block_{block_idx}_{j}")
                 for j in range(self.n_residual_layers)], x)
            x = getattr(self, f"spec_block_{block_idx}")(x, wav)
            if self.res_scale is not None:
                x = x * (1.0 + self.n_residual_layers * self.res_scale**2) ** -0.5
            x = self.act(x)
            x = getattr(self, f"down_{block_idx}_expand")(x)
            x = getattr(self, f"down_{block_idx}_dw")(x)
            if cond is not None:
                width = x.shape[1] // self.freq_bands
                bands = []
                for band_idx in range(self.freq_bands):
                    site = block_idx * self.freq_bands + band_idx
                    bands.append(getattr(self, f"film_{block_idx}_{band_idx}")(
                        x[:, band_idx * width:(band_idx + 1) * width], cond,
                        offsets[:, 2 * site:2 * site + 2]
                        if offsets is not None else None))
                x = torch.cat(bands, dim=1)
        x = self.spec_post(x, wav)
        x = self.post_dw(self.act(x))
        x = self.post_proj(x)
        if self.l2norm_layer is not None:
            x = self.l2norm_layer(x)
        return x


class SEANetDecoder(nn.Module):
    """SEANet decoder: latent ``[B, dimension, T']`` -> audio
    ``[B, channels, T' * prod(ratios)]``."""

    def __init__(self, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, n_residual_layers: int = 1,
                 ratios: Sequence[int] = (8, 5, 4, 2), activation: str = "ELU",
                 alpha: float = 1.0, norm: str = "weight_norm",
                 kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 skip: str = "identity", causal: bool = False,
                 pad_mode: str = "constant", trim_right_ratio: float = 1.0,
                 final_activation: Optional[str] = None, act_all: bool = False,
                 expansion: int = 1, groups: int = -1, use_bias: bool = True,
                 res_scale: Optional[float] = None,
                 wav_std: float = DEFAULT_WAV_STD, zero_init: bool = False,
                 inout_norm: bool = True):
        super().__init__()
        _check_ported(skip, act_all, expansion, groups, zero_init, pad_mode)
        self.act = get_activation(activation, alpha)
        self.ratios = list(ratios)
        self.res_scale, self.n_residual_layers = res_scale, n_residual_layers
        self.wav_std, self.inout_norm = wav_std, inout_norm
        self.final_act = (get_activation(final_activation)
                          if final_activation is not None else None)
        mult = int(2 ** len(self.ratios))
        self.conv_in = SConv1d(dimension, mult * n_filters, 1, norm=norm,
                               use_bias=False)
        self.conv_in_dw = SConv1d(mult * n_filters, mult * n_filters,
                                  kernel_size, groups=mult * n_filters,
                                  norm=norm, causal=causal, use_bias=use_bias)
        for i, ratio in enumerate(self.ratios):
            dim = mult * n_filters
            setattr(self, f"up_{i}_dw", SConvTranspose1d(
                dim, dim, ratio * 2, stride=ratio, groups=dim, norm=norm,
                causal=causal, trim_right_ratio=trim_right_ratio,
                use_bias=False, nonlinearity="relu"))
            setattr(self, f"up_{i}_proj", SConv1d(dim, dim // 2, 1, norm=norm,
                                                  use_bias=use_bias))
            for j in range(n_residual_layers):
                setattr(self, f"block_{i}_{j}", SEANetResnetBlock(
                    dim // 2, kernel_size=residual_kernel_size,
                    dilations=(dilation_base**j, 1), activation=activation,
                    alpha=alpha, norm=norm, causal=causal, use_bias=use_bias,
                    res_scale=res_scale, idx=j))
            mult //= 2
        self.conv_out = SConv1d(n_filters, channels, last_kernel_size,
                                norm=norm, causal=causal, use_bias=use_bias,
                                nonlinearity="relu")

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in_dw(self.conv_in(z))
        for i in range(len(self.ratios)):
            if i > 0 and self.res_scale is not None:
                x = x * (1.0 + self.n_residual_layers * self.res_scale**2) ** -0.5
            x = getattr(self, f"up_{i}_dw")(self.act(x))
            x = getattr(self, f"up_{i}_proj")(x)
            x = _apply_resblock_chain(
                [getattr(self, f"block_{i}_{j}")
                 for j in range(self.n_residual_layers)], x)
        if self.res_scale is not None:
            x = x * (1.0 + self.n_residual_layers * self.res_scale**2) ** -0.5
        x = self.conv_out(self.act(x))
        if self.inout_norm:
            x = x * self.wav_std
        if self.final_act is not None:
            x = self.final_act(x)
        return x
