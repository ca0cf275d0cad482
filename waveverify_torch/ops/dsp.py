"""FIR filters and polyphase resampling (counterpart of the first half of
``waveverify_tpu/ops/dsp.py``).

The kernels are built in numpy exactly as the JAX package builds them and
applied with ``F.conv1d`` along the last axis of ``[..., T]`` audio, in the
audio's dtype and on its device. The JAX package leaves these convolutions
to XLA, so plain PyTorch (cuDNN on the card) is their counterpart. The
STFT helpers are not ported yet.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _hann(n: np.ndarray, width: float) -> np.ndarray:
    """Hann window evaluated at continuous offsets in [-width, width]."""
    out = np.cos(np.pi * n / width / 2) ** 2
    out[np.abs(n) >= width] = 0.0
    return out


@lru_cache(maxsize=None)
def _sinc_filter(cutoff: float, half_width: int, zeros: int = 8) -> np.ndarray:
    """Windowed-sinc lowpass kernel, length ``2 * half_width + 1``, unit DC
    gain. ``cutoff`` is in cycles per sample, (0, 0.5]."""
    t = np.arange(-half_width, half_width + 1, dtype=np.float64)
    window = _hann(t, half_width + 0.5)
    kernel = 2 * cutoff * np.sinc(2 * cutoff * t) * window
    kernel = kernel / kernel.sum() if kernel.sum() != 0 else kernel
    return kernel.astype(np.float32)


def filter_half_width(cutoff: float, zeros: int = 8) -> int:
    """Support radius so the sinc sees ``zeros`` zero crossings per side."""
    return int(math.ceil(zeros / (2 * max(cutoff, 1e-4))))


def fir_filter(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Zero-phase 'same' FIR filtering along the last axis: ``[..., T]`` ->
    ``[..., T]``, ``kernel`` ``[K]`` with K odd."""
    shape = x.shape
    k = kernel.shape[0]
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device).view(1, 1, k)
    xf = F.pad(x.reshape(-1, 1, shape[-1]), (k // 2, k - 1 - k // 2))
    return F.conv1d(xf, w).reshape(shape)


def lowpass_fir(x: torch.Tensor, cutoff: float, zeros: int = 8) -> torch.Tensor:
    """Lowpass at a normalised cutoff (cycles per sample, 0..0.5)."""
    cutoff = float(cutoff)
    return fir_filter(x, _sinc_filter(cutoff, filter_half_width(cutoff, zeros),
                                      zeros))


def highpass_fir(x: torch.Tensor, cutoff: float, zeros: int = 8) -> torch.Tensor:
    """Highpass as identity minus lowpass (the spectral complement)."""
    return x - lowpass_fir(x, cutoff, zeros)


def bandpass_fir(x: torch.Tensor, cutoff_low: float, cutoff_high: float,
                 zeros: int = 8) -> torch.Tensor:
    """Bandpass as lowpass(high) minus lowpass(low)."""
    return lowpass_fir(x, cutoff_high, zeros) - lowpass_fir(x, cutoff_low, zeros)


@lru_cache(maxsize=None)
def resample_kernel(orig_freq: int, new_freq: int, zeros: int = 24,
                    rolloff: float = 0.945) -> Tuple[np.ndarray, int, int]:
    """Polyphase windowed-sinc resampling kernels: ``(kernel [L, 1, q], p,
    q)`` with ``p / q`` the reduced orig / new ratio and ``L = 2 width + p``.

    Output sample ``n = k q + i`` lands at input time ``k p + i p / q``;
    phase i's kernel is the Hann-windowed sinc sampled at ``m - i p / q``
    for ``m`` in ``[-width, width + p)``, so one stride-p correlation gives
    all q phases. Cutoff ``0.5 * rolloff * min(1, q / p)`` cycles per input
    sample; each phase has unit DC gain."""
    g = math.gcd(orig_freq, new_freq)
    p, q = orig_freq // g, new_freq // g
    if p == q:
        return np.ones((1, 1, 1), np.float32), 1, 1
    cutoff = 0.5 * rolloff * min(1.0, q / p)
    width = int(math.ceil(zeros / (2 * cutoff)))
    m = np.arange(-width, width + p, dtype=np.float64)[None, :]  # [1, L]
    f = (np.arange(q, dtype=np.float64) * p / q)[:, None]  # [q, 1]
    t = m - f
    support = zeros / (2 * cutoff)
    window = np.where(np.abs(t) < support, np.cos(np.pi * t / support / 2) ** 2, 0.0)
    kernels = 2 * cutoff * np.sinc(2 * cutoff * t) * window  # [q, L]
    kernels /= kernels.sum(axis=1, keepdims=True)
    return kernels.T[:, None, :].astype(np.float32), p, q


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             zeros: int = 24, rolloff: float = 0.945) -> torch.Tensor:
    """Rational-rate resampling along the last axis: ``[..., T]`` ->
    ``[..., ceil(T * new / orig)]``. One stride-p conv with q output
    channels, then the phases are interleaved."""
    kernel_np, p, q = resample_kernel(orig_freq, new_freq, zeros, rolloff)
    if p == q:
        return x
    shape = x.shape
    t = shape[-1]
    out_t = int(math.ceil(t * q / p))
    n_frames = (out_t + q - 1) // q
    length = kernel_np.shape[0]
    width = (length - p) // 2
    # frame k reads x[k p - width : k p - width + L]
    pad_right = max(0, (n_frames - 1) * p - width + length - t)
    w = torch.as_tensor(np.ascontiguousarray(kernel_np.transpose(2, 1, 0)),
                        dtype=x.dtype, device=x.device)  # [q, 1, L]
    xf = F.pad(x.reshape(-1, 1, t), (width, pad_right))
    y = F.conv1d(xf, w, stride=p)[:, :, :n_frames]  # [N, q, frames]
    y = y.transpose(1, 2).reshape(y.shape[0], -1)[:, :out_t]
    return y.reshape(shape[:-1] + (out_t,))
