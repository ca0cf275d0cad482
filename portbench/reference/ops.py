"""The products of the plain reference, in one of two precisions.

``Ops()`` computes every convolution and matrix product in float32 (the
reference sets TF32 off for cuBLAS and cuDNN before it runs on a card).
``Ops(tf32=True)`` is the control: the same products with both operands
rounded to TF32 (10 mantissa bits, to nearest) and the sums kept in
float32, which is what a tensor core does with TF32 allowed. The rounding
is explicit, so the control computes the same on the CPU and on a card;
its gradient passes the rounding straight through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        bits = x.contiguous().view(torch.int32)
        # round half away from zero on the magnitude, then drop 13 bits
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa."""
    return _RoundTF32.apply(x)


class Ops:
    """conv1d, conv2d, conv_transpose1d and matmul in the reference's
    precision."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def conv1d(self, x, w, b=None, stride=1, dilation=1, groups=1):
        return F.conv1d(self._r(x), self._r(w), b, stride=stride,
                        dilation=dilation, groups=groups)

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self._r(x), self._r(w), b, stride=stride,
                        padding=padding, groups=groups)

    def conv_transpose1d(self, x, w, b=None, stride=1, groups=1):
        return F.conv_transpose1d(self._r(x), self._r(w), b, stride=stride,
                                  groups=groups)

    def matmul(self, a, b):
        return torch.matmul(self._r(a), self._r(b))


def strict_f32() -> None:
    """TF32 off for cuBLAS and cuDNN: float32 products in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
