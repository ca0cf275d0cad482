"""audiocraft's SEANet encoder and decoder (``audiocraft/modules/seanet.py``,
``lstm.py``), as AudioSeal builds them, in PyTorch.

Activations are ``[B, C, T]``. The convs are the port's :class:`SConv1d` /
:class:`SConvTranspose1d`, whose padding and trimming are audiocraft's own
(its ``StreamableConv1d`` / ``StreamableConvTranspose1d``). Every module
sits at audiocraft's index in an ``nn.Sequential`` called ``model``,
activations included, so a state dict of audiocraft's tree maps onto these
modules by renaming its conv leaves alone (``waveverify_torch.convert``).

The residual block is audiocraft's dense one (activation, a k-tap conv
from C to C / ``compress``, activation, a 1x1 conv back to C, plus an
identity or 1x1 shortcut), unlike ``modules/seanet.py``'s pointwise-then-
depthwise block. The LSTM bottleneck holds a ``torch.nn.LSTM`` with
audiocraft's skip; on a card it runs as the persistent recurrence kernel
(``ops/lstm_recurrence.py``). It runs in float32 whatever the serving
dtype, inside the span ``seanet.lstm``. On a card without autograd the
residual block runs as one launch of the fused block kernel
(``ops/dense_resblock.py``), inside the span ``seanet.resblock``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from waveverify_torch import spans
from waveverify_torch.modules.conv import SConv1d, SConvTranspose1d
from waveverify_torch.modules.seanet import get_activation
from waveverify_torch.ops import dense_resblock as dr
from waveverify_torch.ops.lstm_recurrence import device_plan, lstm_recurrence

NORMS = ("none", "weight_norm")


class Activation(nn.Module):
    """An activation of :func:`get_activation` as a module, so it holds its
    index in a ``Sequential``."""

    def __init__(self, name: str, params: Optional[dict] = None):
        super().__init__()
        self.name, self.params = name, dict(params or {})
        self.fn: Callable = get_activation(name, **self.params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class StreamableLSTM(nn.Module):
    """``num_layers`` LSTM layers of width ``dimension`` over the time axis,
    plus the input when ``skip`` (audiocraft's ``StreamableLSTM``).

    On a card without autograd every frame of every layer runs in one
    launch of the persistent recurrence kernel (``lstm.persistent``; one
    per ``max_batch`` batch rows of the plan), where
    :func:`~waveverify_torch.ops.lstm_recurrence.device_plan` finds a plan
    that holds all the layers' weights at once. cuDNN's LSTM runs where none
    fits (on an H100: two layers of 1024 or wider, or over four layers),
    under autograd and on the CPU."""

    def __init__(self, dimension: int, num_layers: int = 2, skip: bool = True):
        super().__init__()
        self.skip = skip
        self.lstm = nn.LSTM(dimension, dimension, num_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with spans.span("seanet.lstm", device=True):
            seq = x.permute(2, 0, 1).float()  # [T, B, C]
            y = self._recur(seq)
            y = y + seq if self.skip else y
            return y.permute(1, 2, 0).to(x.dtype)

    def _recur(self, seq: torch.Tensor) -> torch.Tensor:
        """The LSTM's output ``[T, B, C]``."""
        if seq.is_cuda and not torch.is_grad_enabled():
            lstm = self.lstm
            plan = device_plan(seq.device, lstm.hidden_size, lstm.num_layers)
            if plan is not None:
                return lstm_recurrence(seq, lstm.all_weights, plan)
        return self.lstm(seq)[0]


class SEANetResnetBlock(nn.Module):
    """audiocraft's residual block: (activation, conv) per kernel size, the
    first from ``dim`` to ``dim // compress``, the last back to ``dim``;
    plus an identity shortcut (``true_skip``) or a 1x1 conv.

    On a card without autograd, a block of AudioSeal's form (ELU, a k-tap
    conv with k odd to ``dim // 2``, ELU, a 1x1 conv, both with biases and
    a norm without a module of its own; zero padding, not causal; the
    identity shortcut) at a width the kernel's plan serves runs as one
    launch of the fused block kernel (``resblock.fused``), on the convs'
    effective weights. Every other block, and every block under autograd or
    on the CPU, runs its modules."""

    def __init__(self, dim: int, kernel_sizes: Sequence[int] = (3, 1),
                 dilations: Sequence[int] = (1, 1), activation: str = "ELU",
                 activation_params: Optional[dict] = None, norm: str = "none",
                 causal: bool = False, pad_mode: str = "reflect",
                 compress: int = 2, true_skip: bool = True):
        super().__init__()
        if len(kernel_sizes) != len(dilations):
            raise ValueError("one dilation per kernel size")
        hidden = dim // compress
        block = []
        for i, (k, d) in enumerate(zip(kernel_sizes, dilations)):
            cin = dim if i == 0 else hidden
            cout = dim if i == len(kernel_sizes) - 1 else hidden
            block += [Activation(activation, activation_params),
                      SConv1d(cin, cout, k, dilation=d, norm=norm, causal=causal,
                              pad_mode=pad_mode)]
        self.block = nn.Sequential(*block)
        self.shortcut = (nn.Identity() if true_skip else
                         SConv1d(dim, dim, 1, norm=norm, causal=causal, pad_mode=pad_mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with spans.span("seanet.resblock", device=True):
            plan = self._fused_plan(x)
            if plan is None:
                return self.shortcut(x) + self.block(x)
            conv1, conv2 = self.block[1].conv, self.block[3].conv
            return dr.dense_resblock(x, conv1.weight(), conv1.b, conv2.weight(), conv2.b,
                                     conv1.dilation, self.block[0].params.get("alpha", 1.0),
                                     plan)

    def _fused_plan(self, x: torch.Tensor) -> Optional["dr.ResblockPlan"]:
        """The fused kernel's plan for this block on ``x``, or None where the
        block runs its modules."""
        if not (x.is_cuda and x.dtype == torch.float32 and not torch.is_grad_enabled()
                and self._fused_form(x.shape[1])):
            return None
        conv1 = self.block[1].conv
        return dr.device_plan(x.device, x.shape[1], conv1.kernel_size, conv1.dilation)

    def _fused_form(self, dim: int) -> bool:
        """Whether the block at width ``dim`` has the form the kernel
        computes (see the class's docstring), whatever its input."""
        if not isinstance(self.shortcut, nn.Identity) or len(self.block) != 4:
            return False
        acts, convs = self.block[0::2], self.block[1::2]
        if any(a.name != "ELU" or a.params != acts[0].params for a in acts):
            return False
        if any(c.causal or c.pad_mode != "constant" or c.conv.b is None
               or c.conv.norm is not None or c.conv.stride != 1 or c.conv.groups != 1
               for c in convs):
            return False
        conv1, conv2 = convs[0].conv, convs[1].conv
        return (conv1.kernel_size % 2 == 1 and conv1.v.shape[:2] == (dim // 2, dim)
                and conv2.v.shape == (dim, dim // 2, 1))


def _check_norm(norm: str) -> None:
    if norm not in NORMS:
        raise NotImplementedError(f"norm {norm!r}: audiocraft's SEANet is ported "
                                  f"with {NORMS} only")


class SEANetEncoder(nn.Module):
    """``[B, channels, T]`` -> ``[B, dimension, ceil(T / hop)]``: a conv,
    then per ratio (reversed) the residual blocks, an activation and a
    strided conv doubling the width, then the LSTM, an activation and the
    last conv."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios: Sequence[int] = (8, 5, 4, 2),
                 activation: str = "ELU", activation_params: Optional[dict] = None,
                 norm: str = "none", kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 causal: bool = False, pad_mode: str = "reflect", true_skip: bool = True,
                 compress: int = 2, lstm: int = 0, disable_norm_outer_blocks: int = 0):
        super().__init__()
        _check_norm(norm)
        self.ratios = list(reversed(ratios))
        n_blocks = len(self.ratios) + 2
        if not 0 <= disable_norm_outer_blocks <= n_blocks:
            raise ValueError(f"disable_norm_outer_blocks must lie in [0, {n_blocks}]")
        act = dict(activation=activation, activation_params=activation_params)
        pads = dict(causal=causal, pad_mode=pad_mode)
        mult = 1
        model = [SConv1d(channels, n_filters, kernel_size,
                         norm="none" if disable_norm_outer_blocks >= 1 else norm, **pads)]
        for i, ratio in enumerate(self.ratios):
            block_norm = "none" if disable_norm_outer_blocks >= i + 2 else norm
            for j in range(n_residual_layers):
                model.append(SEANetResnetBlock(
                    mult * n_filters, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), norm=block_norm,
                    compress=compress, true_skip=true_skip, **act, **pads))
            model += [Activation(activation, activation_params),
                      SConv1d(mult * n_filters, mult * n_filters * 2, ratio * 2,
                              stride=ratio, norm=block_norm, **pads)]
            mult *= 2
        if lstm:
            model.append(StreamableLSTM(mult * n_filters, num_layers=lstm))
        model += [Activation(activation, activation_params),
                  SConv1d(mult * n_filters, dimension, last_kernel_size,
                          norm="none" if disable_norm_outer_blocks == n_blocks else norm,
                          **pads)]
        self.model = nn.Sequential(*model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class SEANetDecoder(nn.Module):
    """``[B, dimension, T']`` -> ``[B, channels, T' * hop]``: the encoder's
    mirror (a conv, the LSTM, then per ratio an activation, a transposed
    conv halving the width and the residual blocks, then an activation,
    the last conv and the optional final activation)."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios: Sequence[int] = (8, 5, 4, 2),
                 activation: str = "ELU", activation_params: Optional[dict] = None,
                 final_activation: Optional[str] = None,
                 final_activation_params: Optional[dict] = None,
                 norm: str = "none", kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 causal: bool = False, pad_mode: str = "reflect", true_skip: bool = True,
                 compress: int = 2, lstm: int = 0, disable_norm_outer_blocks: int = 0,
                 trim_right_ratio: float = 1.0):
        super().__init__()
        _check_norm(norm)
        n_blocks = len(ratios) + 2
        if not 0 <= disable_norm_outer_blocks <= n_blocks:
            raise ValueError(f"disable_norm_outer_blocks must lie in [0, {n_blocks}]")
        act = dict(activation=activation, activation_params=activation_params)
        pads = dict(causal=causal, pad_mode=pad_mode)
        mult = 2 ** len(ratios)
        model = [SConv1d(dimension, mult * n_filters, kernel_size,
                         norm="none" if disable_norm_outer_blocks == n_blocks else norm,
                         **pads)]
        if lstm:
            model.append(StreamableLSTM(mult * n_filters, num_layers=lstm))
        for i, ratio in enumerate(ratios):
            block_norm = "none" if disable_norm_outer_blocks >= n_blocks - (i + 1) else norm
            model += [Activation(activation, activation_params),
                      SConvTranspose1d(mult * n_filters, mult * n_filters // 2, ratio * 2,
                                       stride=ratio, norm=block_norm, causal=causal,
                                       trim_right_ratio=trim_right_ratio)]
            for j in range(n_residual_layers):
                model.append(SEANetResnetBlock(
                    mult * n_filters // 2, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), norm=block_norm,
                    compress=compress, true_skip=true_skip, **act, **pads))
            mult //= 2
        model += [Activation(activation, activation_params),
                  SConv1d(n_filters, channels, last_kernel_size,
                          norm="none" if disable_norm_outer_blocks >= 1 else norm, **pads)]
        if final_activation is not None:
            model.append(Activation(final_activation, final_activation_params))
        self.model = nn.Sequential(*model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
