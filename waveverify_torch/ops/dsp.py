"""FIR filters, polyphase resampling and the STFT (counterpart of
``waveverify_tpu/ops/dsp.py``).

The kernels and DFT bases are built in numpy exactly as the JAX package
builds them, kept on each device in each dtype
(:data:`~waveverify_torch.ops.uploads.device_const`), and applied with
``F.conv1d`` or a matmul along the last axis of ``[..., T]`` audio, in the
audio's dtype and on its device. The JAX package leaves these to XLA, so
plain PyTorch (cuDNN and cuBLAS on the card) is their counterpart.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveverify_torch.ops.uploads import device_const


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


def fir_filter(x: torch.Tensor, kernel) -> torch.Tensor:
    """Zero-phase 'same' FIR filtering along the last axis: ``[..., T]`` ->
    ``[..., T]``, ``kernel`` ``[K]`` (numpy or a tensor, K odd; an even K
    pads one sample more on the left)."""
    shape = x.shape
    k = kernel.shape[0]
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device).view(1, 1, k)
    xf = F.pad(x.reshape(-1, 1, shape[-1]), (k // 2, k - 1 - k // 2))
    return F.conv1d(xf, w).reshape(shape)


def _lowpass_kernel(cutoff: float, zeros: int) -> np.ndarray:
    return _sinc_filter(cutoff, filter_half_width(cutoff, zeros), zeros)


def lowpass_fir(x: torch.Tensor, cutoff: float, zeros: int = 8) -> torch.Tensor:
    """Lowpass at a normalised cutoff (cycles per sample, 0..0.5)."""
    return fir_filter(x, device_const(_lowpass_kernel, float(cutoff), zeros,
                                      like=x))


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


def _resample_weight(orig_freq: int, new_freq: int, zeros: int,
                     rolloff: float) -> np.ndarray:
    """:func:`resample_kernel`'s kernels as conv weights ``[q, 1, L]``."""
    kernel, _, _ = resample_kernel(orig_freq, new_freq, zeros, rolloff)
    return np.ascontiguousarray(kernel.transpose(2, 1, 0))


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
    w = device_const(_resample_weight, orig_freq, new_freq, zeros, rolloff,
                     like=x)  # [q, 1, L]
    xf = F.pad(x.reshape(-1, 1, t), (width, pad_right))
    y = F.conv1d(xf, w, stride=p)[:, :, :n_frames]  # [N, q, frames]
    y = y.transpose(1, 2).reshape(y.shape[0], -1)[:, :out_t]
    return y.reshape(shape[:-1] + (out_t,))


# ---------------------------------------------------------------------------
# STFT
# ---------------------------------------------------------------------------


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """``[..., T]`` -> ``[..., n_frames, frame_length]``, frames starting
    every ``hop`` samples (a strided view)."""
    return x.unfold(-1, frame_length, hop)


@lru_cache(maxsize=None)
def _hann_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


@lru_cache(maxsize=None)
def _rdft_basis(n_fft: int) -> np.ndarray:
    """Real-DFT basis ``[n_fft, 2F]``: columns cos then -sin, F = n_fft//2+1;
    ``frames @ basis`` is the rfft as (real, imag) halves."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def _rdft(frames: torch.Tensor, n_fft: int) -> Tuple[torch.Tensor, torch.Tensor]:
    out = torch.matmul(frames, device_const(_rdft_basis, n_fft, like=frames))
    f = n_fft // 2 + 1
    return out[..., :f], out[..., f:]


def _reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis of ``[..., T]`` (``F.pad`` takes reflect
    padding on 2-D and 3-D inputs only)."""
    shape = x.shape
    y = F.pad(x.reshape(-1, 1, shape[-1]), (left, right), mode="reflect")
    return y.reshape(shape[:-1] + (y.shape[-1],))


def stft(x: torch.Tensor, n_fft: int, hop: int,
         window: Optional[torch.Tensor] = None, center: bool = True
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT as (real, imag): ``[..., T]`` -> 2 x ``[..., n_frames,
    n_fft // 2 + 1]``; reflect-padded by n_fft // 2 on each side when
    ``center``, Hann window by default."""
    if window is None:
        window = device_const(_hann_window, n_fft, like=x)
    if center:
        x = _reflect_pad(x, n_fft // 2, n_fft // 2)
    return _rdft(frame_signal(x, n_fft, hop) * window, n_fft)


def stft_match_stride(x: torch.Tensor, window_length: int,
                      hop: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audiotools' STFT with ``match_stride=True``: n_frames ==
    ceil(T / hop). Reflect-pads (window - hop) / 2 on the left, the same
    plus the alignment to a hop multiple on the right, then frames without
    centring. ``[..., T]`` -> (real, imag), each ``[..., n_frames,
    window // 2 + 1]``."""
    if hop is None:
        hop = window_length // 4
    t = x.shape[-1]
    right_align = int(math.ceil(t / hop)) * hop - t
    pad = (window_length - hop) // 2
    x = _reflect_pad(x, pad, pad + right_align)
    frames = frame_signal(x, window_length, hop) * device_const(
        _hann_window, window_length, like=x)
    return _rdft(frames, window_length)
