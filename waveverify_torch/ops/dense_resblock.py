"""Fused dense residual block: the CUDA kernel, its launch plan, and its plain
PyTorch version.

The kernel is ``csrc/dense_resblock.cu`` (see its header for the design).
It replaces no TPU kernel: it runs the residual blocks of AudioSeal's
audiocraft SEANet (``modules/audiocraft.py`` ``SEANetResnetBlock``), which
ran as an ELU, a zero-pad copy, a conv and a bias add per conv, and the
skip's add, each a pass over the activation in device memory. One launch
computes, over ``x [B, C, T]`` (f32),

    y = x + W2 ELU(W1 (*) pad0(ELU(x)) + b1) + b2

with ``W1 [C/2, C, k]`` a k-tap conv of dilation ``d`` (k odd, zero padding
of ``d (k - 1) / 2`` on each side), ``W2 [C, C/2]`` (or ``[C, C/2, 1]``) and
``ELU(v) = v > 0 ? v : alpha * (exp(v) - 1)``.

Both products run on the tensor cores in split TF32 (three passes, sums in
f32), from weights split and laid out in the ``mma.sync`` fragment order
(:func:`pack_weights`; on the card one launch of the library's pack kernel
per conv, :func:`pack_on_card`). The launch plan is this module's alone
(:func:`resblock_plan`): the tiling depends on C (C = 32, 64, 128 and 256
have one; other widths have none, and the caller keeps its plain ops), and
the samples a CTA owns, the slab's strides and its shared memory go to
every launch; the source holds only the compiled tilings, ``WV_DR_TILINGS``.

:func:`dense_resblock` runs the kernel on CUDA tensors with a plan its
caller has made. The library is built with ``nvcc`` on first use, from the
source in this checkout, into ``build/kernels/`` beside the package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from waveverify_torch import spans
from waveverify_torch.ops import nvcc

THREADS = 256
WARPS = THREADS // 32
# (NT1, MT1, NT2, MT2) of each compiled tiling, the source's WV_DR_TILINGS
# (which also holds the CTAs per SM each one's registers aim at): per warp
# NT n-tiles of 8 output channels and MT m-tiles of 16 samples, in the first
# and the second product
TILINGS = ((2, 2, 2, 2), (4, 2, 4, 2))
# the tiling each width takes
WIDTH_TILING = {32: 0, 64: 0, 128: 1, 256: 1}
# An H100's opt-in shared memory per block
H100_SMEM = 232448

SPAN = "resblock.fused"

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dense_resblock.cu"


# --------------------------------------------------------------------------
# launch plan
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ResblockPlan:
    """How one block runs: the tiling (an index into :data:`TILINGS`), the
    samples a CTA owns, the halo rounded up to 4 samples, the slab's strides
    (floats) and the launch's dynamic shared memory (bytes)."""

    tiling: int
    rows: int
    hp: int
    ld: int
    ldh: int
    smem: int


def slab_stride(need: int) -> int:
    """The least stride of at least ``need`` floats that is 8 mod 32: the
    32 lanes' loads of a fragment fall in 32 banks whatever the shift."""
    return (need + 23) // 32 * 32 + 8


def tiling_rows(c: int, tiling: int) -> int:
    """Samples per CTA of ``tiling`` at width ``c``: the first product's
    rows in one pass, which the second's passes divide; 0 where the tiling
    does not fit the width."""
    nt1, mt1, nt2, mt2 = TILINGS[tiling]
    n1 = c // 2
    if n1 % (8 * nt1) or c % (8 * nt2):
        return 0
    wn1, wn2 = n1 // (8 * nt1), c // (8 * nt2)
    if not wn1 or not wn2 or WARPS % wn1 or WARPS % wn2:
        return 0
    r1, r2 = WARPS // wn1 * mt1 * 16, WARPS // wn2 * mt2 * 16
    return r1 if r1 % r2 == 0 else 0


@functools.lru_cache(maxsize=None)
def resblock_plan(c: int, k: int, dilation: int, smem: int = H100_SMEM
                  ) -> Optional[ResblockPlan]:
    """The plan for a block of width ``c`` (hidden ``c // 2``) with a
    ``k``-tap conv of ``dilation``, on a card with ``smem`` bytes of shared
    memory per block; None where no tiling serves the width or the slab
    does not fit."""
    if c not in WIDTH_TILING or k < 1 or k % 2 == 0 or dilation < 1:
        return None
    tiling = WIDTH_TILING[c]
    rows = tiling_rows(c, tiling)
    halo = dilation * (k - 1) // 2
    hp = -(-halo // 4) * 4
    ld, ldh = slab_stride(rows + 2 * hp), slab_stride(rows)
    need = 4 * max(c * ld, c // 2 * ldh)
    if need > smem:
        return None
    return ResblockPlan(tiling, rows, hp, ld, ldh, need)


def device_plan(device: torch.device, c: int, k: int, dilation: int
                ) -> Optional[ResblockPlan]:
    """:func:`resblock_plan` for the card ``device``."""
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin", H100_SMEM)
    return resblock_plan(c, k, dilation, smem)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10-bit mantissa, to nearest."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def pack_weights(w: torch.Tensor, taps: int) -> torch.Tensor:
    """A product's B in the kernel's fragment order, split into TF32 hi and
    lo, from a conv weight ``w [N, K_in, taps]`` (output channels, input
    channels, taps): B[kk][n] = w[n][ci][j] with kk = j K_in + ci; for
    k-step ks (8 rows of B, ks = j K_in / 8 + ci / 8) and the pair p of
    n-tiles (16 columns), lane ``l = 4 g + t`` holds ``(B[8 ks + t][16 p +
    g], B[8 ks + t + 4][16 p + g], B[8 ks + t][16 p + 8 + g], B[8 ks + t +
    4][16 p + 8 + g])``, first their :func:`round_tf32` (hi), then what is
    left (lo = B - hi, exact in f32). Returns ``[taps, K_in / 8, N / 16, 2,
    8, 4, 2, 2]``, contiguous."""
    n, k_in = w.shape[0], w.shape[1]
    v = w.reshape(n // 16, 2, 8, k_in // 8, 2, 4, taps)  # p, hn, g, cs, hk, t, j
    v = v.permute(6, 3, 0, 2, 5, 1, 4).contiguous()
    hi = round_tf32(v)
    return torch.stack([hi, v - hi], dim=3)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------


def elu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """The kernel's ELU: ``x > 0 ? x : alpha * (exp(x) - 1)``."""
    return torch.where(x > 0, x, alpha * (torch.exp(torch.clamp(x, max=0.0)) - 1))


def dense_resblock_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor, dilation: int = 1,
                       alpha: float = 1.0, tf32: bool = False) -> torch.Tensor:
    """The block's output ``[B, C, T]``, computed as the kernel computes it,
    in f32: ``u = ELU(x)`` zero-padded by ``dilation (k - 1) / 2`` on each
    side; the first product as a sum over the taps in order (each tap one
    product over the input channels of the shifted view), then ``+ b1`` and
    the ELU; the second product added to ``x + b2``. ``tf32``: every
    product's operands rounded to TF32 (one TF32 pass, the control)."""
    r = round_tf32 if tf32 else (lambda v: v)
    k = w1.shape[-1]
    t_len = x.shape[-1]
    halo = dilation * (k - 1) // 2
    u = r(F.pad(elu(x.float(), alpha), (halo, halo)))
    w1 = r(w1.float())
    h = 0
    for j in range(k):
        h = h + torch.einsum("oc,bct->bot", w1[:, :, j],
                             u[..., j * dilation:j * dilation + t_len])
    h = r(elu(h + b1.float()[:, None], alpha))
    w2 = r(w2.float().reshape(w2.shape[0], -1))
    return (x.float() + b2.float()[:, None]) + torch.einsum("oc,bct->bot", w2, h)


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------

_LIB = None


def build() -> Path:
    """The kernel library, compiled for sm_90a on first use
    (:func:`waveverify_torch.ops.nvcc.build`). Returns its path."""
    return nvcc.build(_SOURCE)


def bind(path: Path):
    """The kernel library at ``path``, its functions' argument types set."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wv_dense_resblock.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                                      i, i, i, i, i, i, p]
    lib.wv_dense_resblock.restype = i
    lib.wv_dense_resblock_pack.argtypes = [p, p, i, i, i, p]
    lib.wv_dense_resblock_pack.restype = i
    lib.wv_dense_resblock_error_string.argtypes = [i]
    lib.wv_dense_resblock_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = bind(build())
    return _LIB


def _check(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
           b2: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32 [B, C, T], got {x.dtype} {tuple(x.shape)}")
    c, hidden = x.shape[1], x.shape[1] // 2
    if w1.dim() != 3 or w1.shape[:2] != (hidden, c) or b1.shape != (hidden,):
        raise ValueError(f"w1 must be [{hidden}, {c}, k] and b1 [{hidden}]")
    if w2.reshape(w2.shape[0], -1).shape != (c, hidden) or b2.shape != (c,):
        raise ValueError(f"w2 must be [{c}, {hidden}(, 1)] and b2 [{c}]")
    for w in (w1, b1, w2, b2):
        if w.dtype != torch.float32 or w.device != x.device:
            raise ValueError("weights must be f32 on the input's device")


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: " + lib.wv_dense_resblock_error_string(err).decode())


def pack_on_card(w: torch.Tensor, taps: int) -> torch.Tensor:
    """:func:`pack_weights` of a CUDA tensor, in one launch of the
    library's ``pack_kernel``; ``launches`` counts them."""
    lib = _library()
    w = w.float().contiguous()
    n, k_in = w.shape[0], w.shape[1]
    out = torch.empty(taps, k_in // 8, n // 16, 2, 8, 4, 2, 2, device=w.device)
    with torch.cuda.device(w.device):
        err = lib.wv_dense_resblock_pack(w.data_ptr(), out.data_ptr(), n, k_in, taps,
                                         torch.cuda.current_stream(w.device).cuda_stream)
    _raise(lib, err, "dense_resblock weight packing")
    pack_on_card.launches += 1
    return out


pack_on_card.launches = 0


def dense_resblock(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, dilation: int, alpha: float,
                   plan: ResblockPlan) -> torch.Tensor:
    """The block's output ``[B, C, T]`` for a CUDA tensor ``x [B, C, T]``,
    the effective (already normed) conv weights ``w1 [C/2, C, k]``, ``w2
    [C, C/2(, 1)]`` and their biases, by ``plan`` (:func:`device_plan`):
    the weights' packing (two :func:`pack_on_card` launches) and one
    launch of the kernel, which ``launches`` counts."""
    _check(x, w1, b1, w2, b2)
    lib = _library()
    b, c, t_len = x.shape
    k = w1.shape[-1]
    x = x.contiguous()
    p1 = pack_on_card(w1, k)
    p2 = pack_on_card(w2.reshape(c, c // 2, 1), 1)
    b1, b2 = b1.contiguous(), b2.contiguous()
    y = torch.empty_like(x)
    with spans.span(SPAN), torch.cuda.device(x.device):
        err = lib.wv_dense_resblock(
            x.data_ptr(), y.data_ptr(), p1.data_ptr(), b1.data_ptr(), p2.data_ptr(),
            b2.data_ptr(), b, c, t_len, k, dilation, float(alpha), plan.tiling, plan.rows,
            plan.hp, plan.ld, plan.ldh, plan.smem, torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, "dense_resblock kernel launch")
    dense_resblock.launches += 1
    return y


dense_resblock.launches = 0
