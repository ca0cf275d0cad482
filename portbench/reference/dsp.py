"""Plain reference of the signal processing training uses: windowed-sinc
FIR filters, polyphase resampling, the STFTs of the losses and of the
resolution discriminator, and the slaney mel bank. The filter kernels and
DFT bases are built in numpy, in float64 and then rounded to float32."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.ops import Ops


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def sinc_lowpass(cutoff: float, zeros: int = 8) -> np.ndarray:
    """Hann-windowed sinc of unit DC gain, ``zeros`` zero crossings per side;
    ``cutoff`` in cycles per sample."""
    half = int(math.ceil(zeros / (2 * max(cutoff, 1e-4))))
    t = np.arange(-half, half + 1, dtype=np.float64)
    width = half + 0.5
    window = np.cos(np.pi * t / width / 2) ** 2
    window[np.abs(t) >= width] = 0.0
    k = 2 * cutoff * np.sinc(2 * cutoff * t) * window
    return (k / k.sum()).astype(np.float32)


def fir(ops: Ops, x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Zero-phase 'same' filtering of ``[B, T]`` (odd kernel)."""
    k = kernel.shape[0]
    y = ops.conv1d(F.pad(x[:, None, :], (k // 2, k - 1 - k // 2)),
                   _const(kernel, x).view(1, 1, k))
    return y[:, 0]


def lowpass(ops: Ops, x: torch.Tensor, cutoff: float) -> torch.Tensor:
    return fir(ops, x, sinc_lowpass(float(cutoff)))


def resample_kernel(orig: int, new: int, zeros: int = 24,
                    rolloff: float = 0.945) -> Tuple[np.ndarray, int, int]:
    """(kernels ``[q, L]``, p, q): phase i of the q output phases reads the
    input at ``m - i p / q``, ``m`` in ``[-width, width + p)``."""
    g = math.gcd(orig, new)
    p, q = orig // g, new // g
    cutoff = 0.5 * rolloff * min(1.0, q / p)
    width = int(math.ceil(zeros / (2 * cutoff)))
    t = (np.arange(-width, width + p, dtype=np.float64)[None, :]
         - (np.arange(q, dtype=np.float64) * p / q)[:, None])
    support = zeros / (2 * cutoff)
    window = np.where(np.abs(t) < support, np.cos(np.pi * t / support / 2) ** 2, 0.0)
    k = 2 * cutoff * np.sinc(2 * cutoff * t) * window
    k /= k.sum(axis=1, keepdims=True)
    return k.astype(np.float32), p, q


def resample(ops: Ops, x: torch.Tensor, orig: int, new: int) -> torch.Tensor:
    """``[B, T]`` -> ``[B, ceil(T * new / orig)]``."""
    kern, p, q = resample_kernel(orig, new)
    if p == q:
        return x
    t = x.shape[-1]
    out_t = int(math.ceil(t * q / p))
    n_frames = (out_t + q - 1) // q
    length = kern.shape[1]
    width = (length - p) // 2
    pad_right = max(0, (n_frames - 1) * p - width + length - t)
    y = ops.conv1d(F.pad(x[:, None, :], (width, pad_right)),
                   _const(kern, x)[:, None, :], stride=p)[:, :, :n_frames]
    return y.transpose(1, 2).reshape(x.shape[0], -1)[:, :out_t]


def hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def rdft_basis(n_fft: int) -> np.ndarray:
    """``[n_fft, 2F]``: cos columns, then -sin columns."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def _reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(x[:, None, :], (left, right), mode="reflect")[:, 0]


def _frames_dft(ops: Ops, x: torch.Tensor, n_fft: int, hop: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    frames = x.unfold(-1, n_fft, hop) * _const(hann(n_fft), x)
    out = ops.matmul(frames, _const(rdft_basis(n_fft), x))
    f = n_fft // 2 + 1
    return out[..., :f], out[..., f:]


def stft(ops: Ops, x: torch.Tensor, n_fft: int, hop: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centred STFT (reflect padding n_fft // 2): (re, im) ``[B, frames, F]``."""
    return _frames_dft(ops, _reflect(x, n_fft // 2, n_fft // 2), n_fft, hop)


def stft_match_stride(ops: Ops, x: torch.Tensor, window: int, hop: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT with ``ceil(T / hop)`` frames: reflect padding of (window - hop)
    / 2 on the left, the same plus the alignment on the right."""
    t = x.shape[-1]
    right_align = int(math.ceil(t / hop)) * hop - t
    pad = (window - hop) // 2
    return _frames_dft(ops, _reflect(x, pad, pad + right_align), window, hop)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney mel bank ``[n_mels, n_fft // 2 + 1]`` (librosa's defaults)."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / np.maximum(fdiff[:-1, None], 1e-10)
    upper = ramps[2:] / np.maximum(fdiff[1:, None], 1e-10)
    w = np.maximum(0, np.minimum(lower, upper))
    w *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return w.astype(np.float32)
