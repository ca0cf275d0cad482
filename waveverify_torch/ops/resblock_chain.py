"""Fused SEANet residual-block chain: the CUDA kernel, its wrapper, and its
plain PyTorch version.

Counterpart of ``waveverify_tpu/ops/pallas_kernels.py``. The kernel is
``csrc/resblock_chain.cu`` (see its header for the design and what bounds
it on the card); it replaces the TPU kernels ``_resblock_kernel_tbc`` and
``_resblock_kernel``, which compute the same function in two layouts.

Layouts: activations are ``[B, C, T]``, the port's layout, in f32 or
bf16. Weights follow the JAX package's orientation: ``pw [M, Cin, Cout]``
(``u @ pw``), ``dw [M, k, C]``, ``b [M, C]``, stored as f32; under bf16
serving their values are rounded to bf16 first, as the TPU wrapper does.

Dispatch is by the tensor's device: a CPU tensor goes to
:func:`resblock_chain_ref`; a CUDA tensor goes to the kernel, or the call
raises. The library is built with ``nvcc`` on first use, from the sources
in this checkout, into ``build/kernels/`` beside the package.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

MAX_CHANNELS = 768
KERNEL_SIZES = (5,)
_MAX_BLOCKS = 8

# Shared memory per CTA on sm_90 (opt-in maximum), and the budget that
# leaves room for two CTAs on one SM (228 KB per SM, 1 KB reserved per CTA).
_SMEM_FULL = 232448
_SMEM_HALF = 115712
# f32 FMA peak over device-memory bandwidth on an H100 SXM: 67e12 / 3.35e12.
_FLOP_PER_BYTE = 20.0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "resblock_chain.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"


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


def resblock_chain_ref(x: torch.Tensor, pw1s, dw1s, b1s, pw2s, dw2s, b2s, *,
                       prescales: Sequence[float], res_scale: float,
                       alpha: float = 1.0) -> torch.Tensor:
    """M chained residual blocks over ``x [B, C, T]``, step by step, in f32
    (the math of ``_resblock_chain_xla``); the result is cast once to
    ``x.dtype``. Differentiable."""
    xx = x.float()
    for i, ps in enumerate(prescales):
        u = _elu(xx * ps, alpha)
        u = torch.einsum("io,bit->bot", pw1s[i].float(), u)
        u = _elu(_causal_dw(u, dw1s[i].float(), b1s[i].float()), alpha)
        u = torch.einsum("io,bit->bot", pw2s[i].float(), u)
        u = _causal_dw(u, dw2s[i].float(), b2s[i].float())
        xx = u * res_scale + xx
    return xx.to(x.dtype)


# --------------------------------------------------------------------------
# launch plan
# --------------------------------------------------------------------------


def slab_bytes(c: int, rows: int) -> int:
    """Shared memory of one CTA: two f32 slabs of c channels, each channel
    padded to whole 16-row groups plus 4 floats (the kernel's
    ``slab_stride``)."""
    return 2 * 4 * c * (-(-rows // 16) * 16 + 4)


def _tile(c: int, m: int, k: int, budget: int) -> int:
    """Rows of T one CTA owns when its two f32 slabs fit ``budget``; the
    slab (halo + tile) is a whole number of the kernel's 16-row groups."""
    rows = (budget // (2 * 4 * c) - 4) // 16 * 16
    return rows - m * 2 * (k - 1)


def _launch_tile(c: int, m: int, k: int) -> int:
    """Tile for an m-block launch: two CTAs per SM when the tile still
    covers four halos, else the whole shared memory of the SM."""
    halo = m * 2 * (k - 1)
    tt = _tile(c, m, k, _SMEM_HALF)
    return tt if tt >= 4 * halo else _tile(c, m, k, _SMEM_FULL)


def chain_plan(c: int, m: int, k: int) -> List[Tuple[int, int]]:
    """Launches for an m-block chain at width c: ``[(blocks, t_tile), ...]``.

    One launch for the chain reads and writes x once, but its halo grows
    with m and the recompute with it; one launch per block has a halo of
    2(k-1) rows but moves x m times. Per row, the products cost 4 c^2 f32
    FLOP per block and a launch moves 8 c bytes of f32, weighed at the
    card's f32 FLOP-per-byte balance; the cheaper plan wins."""
    def recompute(mm: int) -> float:
        tt = _launch_tile(c, mm, k)
        return (tt + mm * 2 * (k - 1)) / tt if tt > 0 else float("inf")

    io = _FLOP_PER_BYTE * 8 * c
    chain = m * 4 * c * c * recompute(m) + io
    per_block = m * (4 * c * c * recompute(1) + io)
    if chain <= per_block:
        return [(m, _launch_tile(c, m, k))]
    return [(1, _launch_tile(c, 1, k))] * m


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------

_LIB = None


def _nvcc() -> str:
    import shutil

    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the resblock-chain kernel cannot be built")
    return path


def build() -> Path:
    """Compile the kernel library for sm_90a if this source has not been
    built yet. The file name carries a hash of the source; a file lock
    keeps concurrent processes from building the same library twice, and
    the result is moved into place atomically; nvcc's and ptxas's output
    goes to ``<library>.log`` beside it. Returns the library path."""
    import fcntl
    import subprocess

    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    lib = _BUILD_DIR / f"libresblock_chain_{tag}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (_BUILD_DIR / f"{lib.stem}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    if _LIB is None:
        import ctypes

        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wv_resblock_chain.argtypes = [
            p, p, p, p, p, p, p, p, i, i, i, i, i, i,
            ctypes.POINTER(f), f, f, i, p]
        lib.wv_resblock_chain.restype = i
        lib.wv_error_string.argtypes = [i]
        lib.wv_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(x: torch.Tensor, ws: Sequence[torch.Tensor], prescales, res_scale,
            alpha, t_tile: int) -> torch.Tensor:
    import ctypes

    lib = _library()
    b, c, t = x.shape
    m, k = ws[1].shape[0], ws[1].shape[1]
    out = torch.empty_like(x)
    ps = (ctypes.c_float * m)(*[float(p) for p in prescales])
    # the C side launches on the current device: make it x's
    with torch.cuda.device(x.device):
        err = lib.wv_resblock_chain(
            x.data_ptr(), *[w.data_ptr() for w in ws], out.data_ptr(), b, c, t, m,
            k, t_tile, ps, float(res_scale), float(alpha),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("resblock_chain kernel launch failed: "
                           + lib.wv_error_string(err).decode())
    resblock_chain.launches += 1
    return out


def _check(x: torch.Tensor, ws: Sequence[torch.Tensor], m: int) -> None:
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
    if c > MAX_CHANNELS or k not in KERNEL_SIZES or m > _MAX_BLOCKS:
        raise ValueError(f"kernel takes C <= {MAX_CHANNELS}, k in {KERNEL_SIZES} "
                         f"and M <= {_MAX_BLOCKS}; got C={c}, k={k}, M={m}")


def resblock_chain(x: torch.Tensor, pw1s, dw1s, b1s, pw2s, dw2s, b2s, *,
                   prescales: Sequence[float], res_scale: float,
                   alpha: float = 1.0) -> torch.Tensor:
    """One chain of M residual blocks over ``x [B, C, T]``.

    CPU tensors take :func:`resblock_chain_ref`. CUDA tensors take the
    kernel, in the launches :func:`chain_plan` picks; ``launches`` counts
    kernel launches (one per entry of the plan)."""
    ws = (pw1s, dw1s, b1s, pw2s, dw2s, b2s)
    m = len(prescales)
    if x.device.type == "cpu":
        return resblock_chain_ref(x, *ws, prescales=prescales,
                                  res_scale=res_scale, alpha=alpha)
    if x.device.type != "cuda":
        raise RuntimeError(f"resblock_chain: unsupported device {x.device}")
    _check(x, ws, m)
    k = dw1s.shape[1]
    i = 0
    for blocks, t_tile in chain_plan(x.shape[1], m, k):
        sl = slice(i, i + blocks)
        x = _launch(x, [w[sl].contiguous() if blocks < m else w for w in ws],
                    prescales[sl], res_scale, alpha, t_tile)
        i += blocks
    return x


resblock_chain.launches = 0


def launches_per_chain(c: int, m: int, k: int = 5) -> int:
    """Kernel launches one chain of m blocks at width c costs."""
    return len(chain_plan(c, m, k))


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
        with torch.enable_grad():
            y = resblock_chain_ref(*inputs, prescales=prescales,
                                   res_scale=res_scale, alpha=alpha)
        grads = torch.autograd.grad(y, inputs, g, allow_unused=True)
        return (*grads, None, None, None)


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
