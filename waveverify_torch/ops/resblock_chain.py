"""Fused SEANet residual-block chain: the CUDA kernel, its wrapper, and its
plain PyTorch version.

Counterpart of ``waveverify_tpu/ops/pallas_kernels.py``. The kernel is
``csrc/resblock_chain.cu`` (see its header for the design); it replaces the
TPU kernels ``_resblock_kernel_tbc`` and ``_resblock_kernel``, which compute
the same function in two layouts.

Layouts: activations are ``[B, C, T]``, the port's layout, in f32 or
bf16. Weights follow the JAX package's orientation: ``pw [M, Cin, Cout]``
(``u @ pw``), ``dw [M, k, C]``, ``b [M, C]``, stored as f32; under bf16
serving their values are rounded to bf16 first, as the TPU wrapper does.

The 1x1 products run on the tensor cores by one of two routes.
:func:`product_route` alone picks a width's, from a table
(``_WGMMA_WIDTHS``: wgmma at C = 192, mma.sync at every other width), and
every planning function derives the route from the width (the source's
header has both routes):

- ``wgmma``: Hopper's warpgroup ``wgmma.mma_async.m64nNk8`` in TF32, with
  A (time rows x input channels) from registers and B (the weights) from
  shared memory, K-major. :func:`pack_wgmma_weights` lays ``pw`` out as
  the exact shared-memory image the kernel reads (per k-chunk of 8 input
  channels and column block of NB output channels, TF32 hi then lo), and
  one bulk copy moves a whole k-chunk (a ring stage) into a ring.
- ``mma``: the warp-level ``mma.sync.m16n8k8`` TF32 instruction (M = time
  rows, N = output channels, K = input channels). With ``g = lane >> 2``
  and ``t = lane & 3`` a lane holds ``A[g][t], A[g+8][t], A[g][t+4],
  A[g+8][t+4]`` of a 16 x 8 tile of the activation, ``B[t][g], B[t+4][g]``
  of an 8 x 8 tile of ``pw``, and ``D[g][2t], D[g][2t+1], D[g+8][2t],
  D[g+8][2t+1]`` of the 16 x 8 sums. :func:`pack_chain_weights` lays
  ``pw`` out in that order, so that a lane loads the B values of two
  neighbouring tiles as one 16-byte word.

The wrapper keeps the packed copy beside the tensor it was made from.

Split TF32: TF32 keeps 10 mantissa bits, so every operand is split into
``hi = tf32(v)`` (to nearest) and ``lo = tf32(v - hi)`` (toward zero, by
the tensor core itself; :func:`split_tf32`) and the
three products ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` are summed in f32
(:func:`pointwise_tf32x3` is the same arithmetic in PyTorch). With a bf16
activation the weights must hold bf16 values (:func:`stack_chain_weights`
sees to it; the wrapper checks): they are exact in TF32, and the kernel
skips ``a_hi b_lo``. The tensor core adds into its sums toward zero, so for
C > 128 the mma.sync route starts each k-step's products from zero and
carries the sums in f32 adds outside it, which keeps its error at the f32
product's; the wgmma route (C = 192) does so every four k-chunks of 8
channels (6.3e-07 at C = 192 on an H100).

What the kernel takes, and what the wrapper does around it: widths C up to
``MAX_CHANNELS`` (wider chains run block by block in plain PyTorch, as the
JAX package runs them in XLA: ``modules/seanet.py`` routes them there);
depthwise widths k in ``KERNEL_SIZES``; any number of blocks, in launches
of at most ``_MAX_BLOCKS``; any C, zero-padded to a multiple of 16. Zero
weights, zero bias and ELU(0) = 0 keep the padded channels at 0 through
both branches and the identity skip, so the padding changes no output.

Dispatch is by the tensor's device: a CPU tensor goes to
:func:`resblock_chain_ref`; a CUDA tensor goes to the kernel, or the call
raises. The library is built with ``nvcc`` on first use, from the sources
in this checkout, into ``build/kernels/`` beside the package.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from waveverify_torch import spans
from waveverify_torch.ops import nvcc

MAX_CHANNELS = 768
KERNEL_SIZES = (3, 5)
_MAX_BLOCKS = 8  # blocks in one launch (kMaxM in the source)

# Shared memory per CTA on sm_90 (opt-in maximum), and the budget that
# leaves room for two CTAs on one SM (228 KB per SM, 1 KB reserved per CTA).
_SMEM_FULL = 232448
_SMEM_HALF = 115712
# FLOP of the products the kernel does in the time the card moves one byte
# of device memory, for chain_plan's cost model.
_FLOP_PER_BYTE = 40.0
# Product tilings the kernel is compiled for. mma.sync (WV_TILINGS in the
# source): (NT, MT, CTAs per SM). A warp holds MT x NT mma tiles of sums,
# 16 MT rows by 8 NT columns; a tiling for one CTA per SM may use up to 255
# registers.
_TILINGS = ((12, 2, 1), (8, 3, 1), (6, 4, 1), (6, 2, 2), (4, 3, 2))
# The route per width: a width listed here runs wgmma with this tiling, any
# other the mma.sync tiling of product_tiling. Its values are the wgmma
# tilings compiled (WV_WG_TILINGS in the source): (NB, UNITS, CTAs per SM),
# each of the two warpgroups holding UNITS units of 64 rows by NB columns
# of sums. wgmma only where it measured faster on the card: C = 192. At
# C = 64, 96, 128 and 384 it ran slower than mma.sync (PERF.md).
_WGMMA_WIDTHS = {192: (96, 2, 1)}
_WARPS = 8
_WG_ROWS = 64  # rows of one wgmma tile
# Floats of padding per channel of the slab (kSlabPad in the source).
_SLAB_PAD = 4
# The wgmma route's ring: at most _MAX_STAGES stages (kMaxStages) behind
# _BAR_BYTES of mbarriers (kBarBytes); the plan keeps room for two f32
# stages.
_MAX_STAGES = 8
_BAR_BYTES = 2 * _MAX_STAGES * 8
_MIN_STAGES = 2

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "resblock_chain.cu"


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------


def _elu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """ELU as the kernel computes it: exp(min(x, 0)) - 1 below zero."""
    return torch.where(x > 0, x, alpha * (torch.exp(torch.clamp(x, max=0.0)) - 1.0))


def _causal_dw(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """u [B, C, T], w [k, C]: out[t] = sum_j w[j] u[t - (k-1-j)] + b, zero
    history, summed in the kernel's order."""
    k, t = w.shape[0], u.shape[-1]
    acc = u * w[k - 1][:, None]
    for j in range(k - 1):
        shift = k - 1 - j
        shifted = torch.nn.functional.pad(u, (shift, 0))[..., :t]
        acc = acc + shifted * w[j][:, None]
    return acc + b[:, None]


def _pointwise(pw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """1x1 conv: ``out[b, o, t] = sum_i pw[i, o] u[b, i, t]`` in f32."""
    return torch.einsum("io,bit->bot", pw, u)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(v)`` and ``lo = tf32(v - hi)``, where
    tf32 keeps 10 mantissa bits of an f32, by integer arithmetic on the bit
    pattern: hi to nearest (add 0x1000, clear the low 13 bits), lo toward
    zero (clear them, as the tensor core does on reading). The kernel's
    rule."""
    v = v.float().contiguous()
    hi = ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((v - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def pointwise_tf32x3(pw: torch.Tensor, u: torch.Tensor,
                     split_b: bool = True, chunk: Optional[int] = None) -> torch.Tensor:
    """The kernel's product: :func:`_pointwise` from TF32 operands in three
    passes, ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, summed in f32 in that
    order. ``split_b=False`` takes ``pw`` as exact in TF32 (bf16 values) and
    drops the middle pass. ``chunk``: the sums carried outside the tensor
    core, as the one-CTA tilings do (mma.sync every 8 input channels,
    wgmma every 32): each chunk of ``chunk`` input channels sums its
    passes from zero, and the running sum adds them in f32 in k order."""
    if chunk is not None:
        out = torch.zeros(u.shape[0], pw.shape[1], u.shape[2], dtype=torch.float32)
        for k0 in range(0, pw.shape[0], chunk):
            out = out + pointwise_tf32x3(pw[k0:k0 + chunk], u[:, k0:k0 + chunk], split_b)
        return out
    a_hi, a_lo = split_tf32(u)
    b_hi, b_lo = split_tf32(pw)
    out = _pointwise(b_hi, a_lo)
    if split_b:
        out = out + _pointwise(b_lo, a_hi)
    return out + _pointwise(b_hi, a_hi)


def resblock_chain_ref(x: torch.Tensor, pw1s, dw1s, b1s, pw2s, dw2s, b2s, *,
                       prescales: Sequence[float], res_scale: float,
                       alpha: float = 1.0, product=_pointwise) -> torch.Tensor:
    """M chained residual blocks over ``x [B, C, T]``, step by step, in f32
    (the math of ``_resblock_chain_xla``); the result is cast once to
    ``x.dtype``. Differentiable. ``product(pw, u)`` is the 1x1 conv: f32 by
    default, :func:`pointwise_tf32x3` to follow the kernel's arithmetic."""
    xx = x.float()
    for i, ps in enumerate(prescales):
        u = _elu(xx * ps, alpha)
        u = product(pw1s[i].float(), u)
        u = _elu(_causal_dw(u, dw1s[i].float(), b1s[i].float()), alpha)
        u = product(pw2s[i].float(), u)
        u = _causal_dw(u, dw2s[i].float(), b2s[i].float())
        xx = u * res_scale + xx
    return xx.to(x.dtype)


# --------------------------------------------------------------------------
# launch plan
# --------------------------------------------------------------------------


def product_tiling(c: int) -> Tuple[int, int, int]:
    """``(NT, MT, CTAs per SM)`` of the mma.sync product at width c, from
    the compiled tilings. ``wn = ceil(c / (8 NT))`` warps cover the columns
    and ``8 // wn`` row groups share a chunk. Widths up to 128 take a tiling
    whose registers leave two CTAs on an SM; wider ones take 96 sums per
    thread and one CTA. Among those the tiling that keeps most of the
    warps' columns and row groups in use wins, then the one with more sums
    per thread, then the one with more warps across the columns."""
    best, best_key = None, None
    for nt, mt, ctas in _TILINGS:
        wn = -(-c // (8 * nt))
        if wn > _WARPS or ctas != (2 if c <= 128 else 1):
            continue
        used = c / (wn * 8 * nt) * (wn * (_WARPS // wn)) / _WARPS
        key = (used, nt * mt, wn)
        if best_key is None or key > best_key:
            best, best_key = (nt, mt, ctas), key
    if best is None:
        raise ValueError(f"no product tiling for C={c}")
    return best


Route = Tuple[str, Tuple[int, int, int]]


def product_route(c: int) -> Route:
    """The product's route at width c: ``("wgmma", (NB, UNITS, CTAs per
    SM))`` for a width in ``_WGMMA_WIDTHS``, else ``("mma", (NT, MT, CTAs
    per SM))`` from :func:`product_tiling`. One route per width, by the
    table alone."""
    if c in _WGMMA_WIDTHS:
        return "wgmma", _WGMMA_WIDTHS[c]
    return "mma", product_tiling(c)


def chunk_rows(c: int) -> int:
    """Rows R of one mma.sync product pass at width c: every pass re-reads
    the C x C matrix from L2, so the product does R / 2 FLOP per L2 byte."""
    nt, mt, _ = product_tiling(c)
    return _WARPS // -(-c // (8 * nt)) * 16 * mt


def rows_per_pass(c: int) -> int:
    """Rows one product pass (sweep) covers on the width's route:
    mma.sync's :func:`chunk_rows`; for wgmma, the 2 UNITS (row tile, column
    block) units of the two warpgroups cover every column block of 2 UNITS
    / (c / NB) row tiles of 64. Every pass streams the C x C matrix once."""
    kind, (a, b, _) = product_route(c)
    if kind == "mma":
        return chunk_rows(c)
    return 2 * b // (c // a) * _WG_ROWS


def stage_bytes(c: int, split: bool = True) -> int:
    """Bytes of one wgmma ring stage, one bulk copy: a k-chunk of 8 input
    channels by all c output channels in TF32 hi and, with ``split``
    (f32), lo."""
    return (2 if split else 1) * c * 8 * 4


def slab_bytes(c: int, rows: int) -> int:
    """Shared memory of the two f32 slabs of one CTA: c channels, each
    channel padded to whole 16-row groups plus ``_SLAB_PAD`` floats (the
    kernel's ``slab_stride``)."""
    return 2 * 4 * c * (-(-rows // 16) * 16 + _SLAB_PAD)


def smem_bytes(c: int, rows: int, stages: int = _MIN_STAGES, split: bool = True) -> int:
    """Shared memory of one CTA (the kernel's ``chain_smem``): the slabs
    and, on the wgmma route, the ring's barriers and ``stages`` stages."""
    if product_route(c)[0] == "mma":
        return slab_bytes(c, rows)
    return slab_bytes(c, rows) + _BAR_BYTES + stages * stage_bytes(c, split)


def _slab_rows(c: int, budget: int) -> int:
    """Rows of the slabs (halo + tile) that fit ``budget`` beside the
    route's minimum ring: a whole number of 16-row groups, and one product
    pass where a second pass would be at most a quarter full (every pass
    re-reads the C x C matrix, whatever rows it has left)."""
    ring = smem_bytes(c, 0) - slab_bytes(c, 0)
    rows = ((budget - ring) // (2 * 4 * c) - _SLAB_PAD) // 16 * 16
    r = rows_per_pass(c)
    return r if r < rows <= r + r // 4 else rows


def _tile(c: int, m: int, k: int, budget: int) -> int:
    """Rows of T one CTA owns when its slabs and ring fit ``budget``."""
    return _slab_rows(c, budget) - m * 2 * (k - 1)


def _launch_tile(c: int, m: int, k: int) -> int:
    """Tile for an m-block launch: two CTAs per SM when the product's
    tiling allows two and the tile still covers four halos, else the whole
    shared memory of the SM."""
    halo = m * 2 * (k - 1)
    tt = _tile(c, m, k, _SMEM_HALF)
    if product_route(c)[1][2] == 2 and tt >= 4 * halo:
        return tt
    return _tile(c, m, k, _SMEM_FULL)


def ring_stages(c: int, rows: int, bf16: bool = False) -> int:
    """Stages of the wgmma ring beside slabs of ``rows`` rows: as many as
    the CTA's budget leaves (two CTAs per SM where the plan chose that),
    at most ``_MAX_STAGES``; 0 on the mma.sync route."""
    kind, (_, _, ctas) = product_route(c)
    if kind == "mma":
        return 0
    base = slab_bytes(c, rows) + _BAR_BYTES
    half = ctas == 2 and base + _MIN_STAGES * stage_bytes(c) <= _SMEM_HALF
    budget = _SMEM_HALF if half else _SMEM_FULL
    return min(_MAX_STAGES, (budget - base) // stage_bytes(c, not bf16))


def _groups(m: int) -> List[int]:
    """Blocks per launch of a chain of m blocks in the fewest launches of
    at most ``_MAX_BLOCKS``, of near-equal length."""
    n = -(-m // _MAX_BLOCKS)
    return [m // n + (i < m % n) for i in range(n)]


def plan_threshold(c: int, m: int, k: int) -> Optional[float]:
    """The FLOP per byte at and above which :func:`chain_plan` runs the
    chain in :func:`_groups` launches rather than one launch per block: the
    products' extra halo recompute over the device-memory traffic the
    fewer launches save. None when the two plans are the same launches."""
    def recompute(mm: int) -> float:
        tt = _launch_tile(c, mm, k)
        return (tt + mm * 2 * (k - 1)) / tt if tt > 0 else float("inf")

    groups = _groups(m)
    if len(groups) == m:
        return None
    extra = sum(g * 4 * c * c * recompute(g) for g in groups) - m * 4 * c * c * recompute(1)
    return extra / (8 * c * (m - len(groups)))


def chain_plan(c: int, m: int, k: int) -> List[Tuple[int, int]]:
    """Launches for an m-block chain at width c (a multiple of 16):
    ``[(blocks, t_tile), ...]``.

    One launch for the chain reads and writes x once, but its halo grows
    with m and the recompute with it; one launch per block has a halo of
    2(k-1) rows but moves x m times. Per row, the products cost 4 c^2 f32
    FLOP per block and a launch moves 8 c bytes of f32, weighed at the
    card's f32 FLOP-per-byte balance (:func:`plan_threshold`); the cheaper
    plan wins. A chain of more than ``_MAX_BLOCKS`` blocks is cut into the
    fewest launches of near-equal length; the blocks are sequential, so the
    result is the same. The tiles follow the width's route
    (:func:`product_route`)."""
    threshold = plan_threshold(c, m, k)
    if threshold is None or _FLOP_PER_BYTE >= threshold:
        return [(g, _launch_tile(c, g, k)) for g in _groups(m)]
    return [(1, _launch_tile(c, 1, k))] * m


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------

_LIB = None


def build() -> Path:
    """The kernel library, compiled for sm_90a on first use
    (:func:`waveverify_torch.ops.nvcc.build`). Returns its path."""
    return nvcc.build(_SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        import ctypes

        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wv_resblock_chain.argtypes = [
            p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
            ctypes.POINTER(f), f, f, i, p]
        lib.wv_resblock_chain.restype = i
        lib.wv_resblock_chain_info.argtypes = [
            i, i, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.wv_resblock_chain_info.restype = i
        lib.wv_error_string.argtypes = [i]
        lib.wv_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def pack_chain_weights(pw: torch.Tensor) -> torch.Tensor:
    """``pw [M, Cin, Cout]`` in the order the kernel's lanes read it:
    ``[M, Cin / 8, Cout / 16, 32, 4]``. Entry ``[m, ks, p, l, 2 q + h]`` is
    ``pw[m, 8 ks + 4 h + (l & 3), 16 p + 8 q + (l >> 2)]``: for k-step ks,
    lane l's ``b0`` (h = 0) and ``b1`` (h = 1) of the n-tiles 2p and 2p + 1."""
    m, c, c_out = pw.shape
    if c != c_out or c % 16:
        raise ValueError(f"pw must be [M, C, C] with C a multiple of 16, got "
                         f"{tuple(pw.shape)}")
    v = pw.reshape(m, c // 8, 2, 4, c // 16, 2, 8)  # m ks h t p q g
    return v.permute(0, 1, 4, 6, 3, 5, 2).reshape(m, c // 8, c // 16, 32, 4).contiguous()


def unpack_chain_weights(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_chain_weights`."""
    m, nks, npairs = packed.shape[:3]
    v = packed.reshape(m, nks, npairs, 8, 4, 2, 2)  # m ks p g t q h
    return v.permute(0, 1, 6, 4, 2, 5, 3).reshape(m, nks * 8, npairs * 16).contiguous()


def pack_wgmma_weights(pw: torch.Tensor, nb: int, split: bool = True) -> torch.Tensor:
    """``pw [M, Cin, Cout]`` as the wgmma route's ring stages:
    ``[M, Cin / 8, Cout / nb, parts, nb / 8, 2, 8, 4]``, one stage per
    (k-chunk ks, column block cb), each the exact shared-memory image the
    kernel's descriptor reads (K-major, no swizzle). Entry ``[m, ks, cb, p,
    n8, kh, n, k]`` is part p of ``pw[m, 8 ks + 4 kh + k, nb cb + 8 n8 + n]``
    (B[k][n] at float ``(n / 8) 64 + (k / 4) 32 + (n % 8) 4 + k % 4`` of
    the stage): p = 0 is ``hi = tf32(w)`` (to nearest), p = 1 (``split``,
    the f32 kernel) is ``lo = w - hi`` with all its f32 bits, which the
    tensor core cuts to TF32 toward zero on reading, so ``hi + lo == w``."""
    m, c, c_out = pw.shape
    if c != c_out or c % 16 or c % nb or nb % 8:
        raise ValueError(f"pw must be [M, C, C] with C a multiple of 16 and of "
                         f"nb={nb}, got {tuple(pw.shape)}")
    w = pw.float().contiguous()
    hi = split_tf32(w)[0]
    parts = [hi, w - hi] if split else [hi]
    v = torch.stack([q.reshape(m, c // 8, 2, 4, c // nb, nb // 8, 8) for q in parts],
                    dim=-1)  # m ks kh k cb n8 n p
    return v.permute(0, 1, 4, 7, 5, 2, 6, 3).contiguous()


def unpack_wgmma_weights(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_wgmma_weights`: the sum of the parts."""
    m, nks, ncb, _, n8 = packed.shape[:5]
    v = packed.sum(dim=3)  # m ks cb n8 kh n k
    return v.permute(0, 1, 4, 6, 2, 3, 5).reshape(m, nks * 8, ncb * n8 * 8).contiguous()


def _packed(pw: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``pw`` in the order its width's route reads it
    (:func:`pack_chain_weights` or :func:`pack_wgmma_weights`), kept on the
    tensor until it is written in place. ``bf16``: the activation is bf16,
    so the kernel will take ``pw`` as exact in TF32 and skip the ``a_hi
    b_lo`` pass (the wgmma image then holds hi alone); values that are not
    bf16 values would be cut to 10 mantissa bits there, so they raise here
    (checked once per version of the tensor)."""
    key = (pw.data_ptr(), pw._version, bf16)
    hit = getattr(pw, "_packed_for_kernel", None)
    if hit is None or hit[0] != key:
        w = pw.detach()
        if bf16 and not torch.equal(w, w.bfloat16().float()):
            raise ValueError("with a bfloat16 activation pw must hold bfloat16 "
                             "values (see stack_chain_weights)")
        kind, (a, _, _) = product_route(pw.shape[-1])
        image = (pack_chain_weights(w) if kind == "mma"
                 else pack_wgmma_weights(w, a, split=not bf16))
        hit = (key, image)
        pw._packed_for_kernel = hit
    return hit[1]


def _launch(x: torch.Tensor, ws: Sequence[torch.Tensor], prescales, res_scale,
            alpha, t_tile: int) -> torch.Tensor:
    """One launch. ``ws`` holds pw1 and pw2 in the width's route's order."""
    import ctypes

    lib = _library()
    b, c, t = x.shape
    m, k = ws[1].shape[0], ws[1].shape[1]
    kind, (ta, tb, _) = product_route(c)
    bf16 = x.dtype == torch.bfloat16
    stages = ring_stages(c, m * 2 * (k - 1) + min(t_tile, t), bf16)
    out = torch.empty_like(x)
    ps = (ctypes.c_float * m)(*[float(p) for p in prescales])
    # the C side launches on the current device: make it x's
    with torch.cuda.device(x.device):
        err = lib.wv_resblock_chain(
            x.data_ptr(), *[w.data_ptr() for w in ws], out.data_ptr(), b, c, t, m,
            k, t_tile, int(kind == "wgmma"), ta, tb, stages, ps, float(res_scale),
            float(alpha), int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("resblock_chain kernel launch failed: "
                           + lib.wv_error_string(err).decode())
    resblock_chain.launches += 1
    return out


def kernel_info(c: int, rows: int, bf16: bool = False) -> Tuple[int, int, int]:
    """``(registers per thread, CTAs resident on one SM, shared memory per
    CTA)`` of the kernel a launch at width c (k = 5) takes when its slabs
    hold ``rows`` rows (with :func:`ring_stages` stages on the wgmma
    route). Needs the card."""
    import ctypes

    lib = _library()
    kind, (ta, tb, _) = product_route(c)
    regs, ctas, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = lib.wv_resblock_chain_info(c, rows, int(kind == "wgmma"), ta, tb,
                                     ring_stages(c, rows, bf16), int(bf16),
                                     ctypes.byref(regs), ctypes.byref(ctas),
                                     ctypes.byref(smem))
    if err != 0:
        raise RuntimeError("resblock_chain kernel query failed: "
                           + lib.wv_error_string(err).decode())
    return regs.value, ctas.value, smem.value


def _check(x: torch.Tensor, ws: Sequence[torch.Tensor], m: int) -> None:
    """Raise on what the kernel does not take: the wrapper calls it after
    padding the channels, so a width that is no multiple of 16 raises only
    in a direct call."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _, c, _ = x.shape
    k = ws[1].shape[1]
    shapes = [(m, c, c), (m, k, c), (m, c)] * 2
    for w, shape in zip(ws, shapes):
        if tuple(w.shape) != shape:
            raise ValueError(f"weight shape {tuple(w.shape)} != {shape}")
        if w.dtype != torch.float32 or w.device != x.device:
            raise TypeError("weights must be float32 on x's device")
        if not w.is_contiguous():
            raise ValueError("weights must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if c > MAX_CHANNELS or k not in KERNEL_SIZES:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS} and k in "
                         f"{KERNEL_SIZES}; got C={c}, k={k}, M={m}")
    if c % 16:
        raise ValueError(f"kernel takes C a multiple of 16 (its products run as "
                         f"pairs of 8-column mma tiles); got C={c}")


def resblock_chain(x: torch.Tensor, pw1s, dw1s, b1s, pw2s, dw2s, b2s, *,
                   prescales: Sequence[float], res_scale: float,
                   alpha: float = 1.0) -> torch.Tensor:
    """One chain of M residual blocks over ``x [B, C, T]``.

    CPU tensors take :func:`resblock_chain_ref`. CUDA tensors take the
    kernel, on channels padded to a multiple of 16 (:func:`pad_channels`),
    in the launches :func:`chain_plan` picks; ``launches`` counts kernel
    launches (one per entry of the plan)."""
    ws = (pw1s, dw1s, b1s, pw2s, dw2s, b2s)
    if x.device.type == "cpu":
        return resblock_chain_ref(x, *ws, prescales=prescales,
                                  res_scale=res_scale, alpha=alpha)
    if x.device.type != "cuda":
        raise RuntimeError(f"resblock_chain: unsupported device {x.device}")
    return _run(x, ws, prescales, res_scale, alpha)


def _run(x: torch.Tensor, ws: Sequence[torch.Tensor], prescales, res_scale,
         alpha) -> torch.Tensor:
    """The kernel on a CUDA tensor: channels padded, weights checked and
    packed, the launches of :func:`chain_plan` on the width's route."""
    c = x.shape[1]
    m = len(prescales)
    x, ws = pad_channels(x, ws)
    _check(x, ws, m)
    k = ws[1].shape[1]
    bf16 = x.dtype == torch.bfloat16
    ws = (_packed(ws[0], bf16), ws[1], ws[2], _packed(ws[3], bf16), ws[4], ws[5])
    i = 0
    for blocks, t_tile in chain_plan(x.shape[1], m, k):
        sl = slice(i, i + blocks)  # a slice of whole blocks stays contiguous
        x = _launch(x, [w[sl] for w in ws], prescales[sl], res_scale, alpha, t_tile)
        i += blocks
    return x if x.shape[1] == c else x[:, :c].contiguous()


def padded_width(c: int) -> int:
    """The width the kernel runs a chain of width c at."""
    return -(-c // 16) * 16


def pad_channels(x: torch.Tensor, ws: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``x [B, C, T]`` and the six weights with their channels zero-padded
    to :func:`padded_width`; the same tensors where C is a multiple of 16.
    The padded channels stay exactly 0 through every block, so the first C
    channels of the result are the chain's."""
    c = x.shape[1]
    p = padded_width(c) - c
    if p == 0:
        return x, tuple(ws)
    pw1, dw1, b1, pw2, dw2, b2 = ws
    return (torch.nn.functional.pad(x, (0, 0, 0, p)),
            (_padded(pw1, (0, p, 0, p)), _padded(dw1, (0, p)), _padded(b1, (0, p)),
             _padded(pw2, (0, p, 0, p)), _padded(dw2, (0, p)), _padded(b2, (0, p))))


def _padded(w: torch.Tensor, pad: Tuple[int, ...]) -> torch.Tensor:
    """``w`` zero-padded by ``pad``, kept on ``w`` until it is written in
    place, so that the padded ``pw`` keeps its :func:`_packed` copy."""
    key = (w.data_ptr(), w._version, pad)
    hit = getattr(w, "_padded_for_kernel", None)
    if hit is None or hit[0] != key:
        hit = (key, torch.nn.functional.pad(w.detach(), pad))
        w._padded_for_kernel = hit
    return hit[1]


resblock_chain.launches = 0


def launches_per_chain(c: int, m: int, k: int = 5) -> int:
    """Kernel launches one chain of m blocks at width c costs."""
    return len(chain_plan(padded_width(c), m, k))


class ResblockChainFn(torch.autograd.Function):
    """Forward: :func:`resblock_chain`. Backward: gradients of
    :func:`resblock_chain_ref`, recomputed under autograd."""

    @staticmethod
    def forward(ctx, x, pw1s, dw1s, b1s, pw2s, dw2s, b2s, prescales, res_scale,
                alpha):
        ctx.save_for_backward(x, pw1s, dw1s, b1s, pw2s, dw2s, b2s)
        ctx.statics = (tuple(prescales), res_scale, alpha)
        return resblock_chain(x, pw1s, dw1s, b1s, pw2s, dw2s, b2s,
                              prescales=prescales, res_scale=res_scale,
                              alpha=alpha)

    @staticmethod
    def backward(ctx, g):
        prescales, res_scale, alpha = ctx.statics
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        # a span (and the profiler's range) of this name, so a profile can
        # sum the plain backward's kernels
        with spans.span(BACKWARD_RANGE), torch.enable_grad():
            y = resblock_chain_ref(*inputs, prescales=prescales,
                                   res_scale=res_scale, alpha=alpha)
            grads = torch.autograd.grad(y, inputs, g, allow_unused=True)
        return (*grads, None, None, None)


BACKWARD_RANGE = "resblock_chain_ref_backward"


def stack_chain_weights(slots, dtype: torch.dtype) -> List[torch.Tensor]:
    """The kernel's six weight tensors for a chain. ``slots`` is a length-M
    list of ``(pw1, dw1, b1, pw2, dw2, b2)``; each is stacked over M and
    rounded to the activation ``dtype``, as the TPU wrapper does (under
    bf16 that quantises the weight values; the arithmetic stays f32), then
    kept as f32."""
    return [torch.stack([s[i].to(dtype) for s in slots]).float().contiguous()
            for i in range(6)]


def fused_resblock_chain(x: torch.Tensor, weights: Sequence[torch.Tensor], *,
                         prescales: Sequence[float], res_scale: float,
                         alpha: float = 1.0) -> torch.Tensor:
    """Chain of M blocks over ``x [B, C, T]`` with the weights of
    :func:`stack_chain_weights`; differentiable."""
    return ResblockChainFn.apply(x.contiguous(), *weights, tuple(prescales),
                                 float(res_scale), float(alpha))
