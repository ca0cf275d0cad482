"""Audio analysis and synthesis transforms: STDCT, MDCT, PQMF (counterpart
of ``waveverify_tpu/ops/transforms.py``).

Each transform holds a numpy filter bank built at construction, kept on
each device in each dtype under its content
(:data:`~waveverify_torch.ops.uploads.device_const`), and runs one strided
``F.conv1d`` (analysis) or ``F.conv_transpose1d`` (synthesis) per call, on
the input's device and dtype. Shapes follow the JAX package:
waveforms ``[B, T]``, spectra ``[B, frames, bins]``. On the card the
convolutions take cuDNN's TF32 setting (``serve.strict_f32`` turns it off).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveverify_torch.ops.uploads import device_const

PI = math.pi

# PQMF defaults of the reference
DEFAULT_BETA = 9.0
DEFAULT_CUTOFF_RATIO = 0.142
DEFAULT_TAPS = 62
DEFAULT_SUBBANDS = 4


BankKey = Tuple[bytes, Tuple[int, ...]]


def _frombuffer(data: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    return np.frombuffer(data, np.float32).reshape(shape).copy()


def _key(bank: np.ndarray) -> BankKey:
    """An f32 bank by its content, as :func:`_frombuffer` rebuilds it."""
    return np.ascontiguousarray(bank, np.float32).tobytes(), bank.shape


def _conv_bank(x: torch.Tensor, bank: BankKey, stride: int,
               padding: int) -> torch.Tensor:
    """x ``[B, T]``; bank ``[bins, K]`` (its :func:`_key`) -> ``[B,
    frames, bins]``, a strided correlation with zero padding on both
    sides."""
    w = device_const(_frombuffer, *bank, like=x)[:, None, :]  # (bins, 1, K)
    return F.conv1d(x[:, None, :], w, stride=stride, padding=padding).transpose(1, 2)


def _convt_bank(spec: torch.Tensor, bank: BankKey, stride: int,
                padding: int, output_padding: int) -> torch.Tensor:
    """spec ``[B, frames, bins]``; bank ``[bins, K]`` (its :func:`_key`) ->
    ``[B, T]``, torch ``conv_transpose1d(stride, padding,
    output_padding)``."""
    # (Cin = bins, Cout = 1, K)
    w = device_const(_frombuffer, *bank, like=spec)[:, None, :]
    return F.conv_transpose1d(spec.transpose(1, 2), w, stride=stride,
                              padding=padding,
                              output_padding=output_padding)[:, 0]


class STDCT:
    """Short-time DCT-II as a strided conv against a windowed orthonormal
    DCT basis, with a NOLA-compensated inverse."""

    def __init__(self, N: int, hop_size: int,
                 window: Optional[np.ndarray] = None):
        self.N = N
        self.hop_size = hop_size
        self.padding = (N - hop_size + 1) // 2
        self.output_padding = (N - hop_size) % 2
        self.clip = hop_size % 2 == 1
        if window is None:
            window = np.ones(N, np.float32)
        window = np.asarray(window, np.float32)
        n = np.arange(N, dtype=np.float64)[None, :]
        k = np.arange(N, dtype=np.float64)[:, None]
        basis = np.cos(PI / N * k * (n + 0.5)) * math.sqrt(2.0 / N)
        basis[0] /= math.sqrt(2.0)  # orthonormal DCT-II first row
        self.filter = (basis * window[None, :]).astype(np.float32)  # [N, N]
        self.window_square = (window ** 2).astype(np.float32)
        self._filter = _key(self.filter)
        self._window_square = _key(self.window_square[None, :])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, T]`` -> ``[B, frames, N]``."""
        y = _conv_bank(x, self._filter, self.hop_size, self.padding)
        return y[:, :-1, :] if self.clip else y

    def inverse(self, spec: torch.Tensor) -> torch.Tensor:
        """spec ``[B, frames, N]`` -> ``[B, T]``, divided by the overlapped
        window energy (floored at 1e-11, the NOLA condition)."""
        wav = _convt_bank(spec, self._filter, self.hop_size, self.padding,
                          self.output_padding)
        ones = spec.new_ones((1, spec.shape[1], 1))
        wsq = _convt_bank(ones, self._window_square, self.hop_size,
                          self.padding, self.output_padding)
        return wav / torch.clamp(wsq, min=1e-11)

    def nola_satisfied(self) -> bool:
        """Whether the (window, hop) pair overlaps to a nonzero energy
        everywhere away from the edges (host numpy)."""
        frames = 8
        acc = np.zeros(self.hop_size * (frames - 1) + self.N, np.float64)
        for f in range(frames):
            acc[f * self.hop_size: f * self.hop_size + self.N] += self.window_square
        inner = acc[self.N: -self.N] if len(acc) > 2 * self.N else acc
        return bool((inner > 1e-11).all())


class MDCT:
    """Modified DCT, frame 2N and hop N:
    ``X[k] = sum_n x[n] cos(pi/N (n + 0.5 + N/2)(k + 0.5))``."""

    def __init__(self, N: int, normalize: bool = True):
        self.N = N
        self.normalize = normalize
        k = np.arange(N, dtype=np.float64)[:, None]
        n = np.arange(2 * N, dtype=np.float64)[None, :]
        basis = np.cos(PI / N * (n + 0.5 + N / 2) * (k + 0.5))
        if normalize:
            basis = basis / math.sqrt(N)
        self.filter = basis.astype(np.float32)  # [N, 2N]
        self._filter = _key(self.filter)
        self._inverse = _key(self.filter if normalize else self.filter / N)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, N * frames]`` -> ``[B, frames + 1, N]``."""
        return _conv_bank(x, self._filter, self.N, self.N)

    def inverse(self, spec: torch.Tensor) -> torch.Tensor:
        """spec ``[B, frames + 1, N]`` -> ``[B, N * frames]`` (TDAC
        overlap-add)."""
        return _convt_bank(spec, self._inverse, self.N, self.N, 0)


def design_prototype_filter(taps: int = DEFAULT_TAPS,
                            cutoff_ratio: float = DEFAULT_CUTOFF_RATIO,
                            beta: float = DEFAULT_BETA) -> np.ndarray:
    """The Kaiser-windowed prototype lowpass of PQMF, ``taps + 1`` long
    (float64)."""
    if taps % 2 != 0:
        raise ValueError(f"taps must be even, got {taps}")
    if not 0.0 < cutoff_ratio < 1.0:
        raise ValueError(f"cutoff_ratio must be in (0, 1), got {cutoff_ratio}")
    omega_c = PI * cutoff_ratio
    n = np.arange(taps + 1, dtype=np.float64) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_ideal = np.sin(omega_c * n) / (PI * n)
    h_ideal[taps // 2] = cutoff_ratio
    try:
        from scipy.signal.windows import kaiser
    except ImportError:
        from numpy import kaiser
    return h_ideal * kaiser(taps + 1, beta)


class PQMF:
    """Pseudo-QMF cosine-modulated filterbank: near-perfect reconstruction,
    critically sampled into ``subbands`` bands."""

    def __init__(self, subbands: int = DEFAULT_SUBBANDS,
                 taps: int = DEFAULT_TAPS,
                 cutoff_ratio: float = DEFAULT_CUTOFF_RATIO,
                 beta: float = DEFAULT_BETA):
        self.subbands = subbands
        self.taps = taps
        h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
        k = np.arange(subbands, dtype=np.float64)[:, None]
        n = np.arange(taps + 1, dtype=np.float64)[None, :]
        modulation = np.cos((2 * k + 1) * PI / (2 * subbands) * (n - taps / 2)
                            + ((-1.0) ** k) * PI / 4)
        self.bank = (2.0 * h_proto[None, :] * modulation
                     * math.sqrt(subbands)).astype(np.float32)  # [subbands, taps + 1]
        self._bank = _key(self.bank)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, T]`` -> subbands ``[B, T // subbands, subbands]``."""
        return _conv_bank(x, self._bank, self.subbands, self.taps // 2)

    def synthesis(self, subband_signals: torch.Tensor) -> torch.Tensor:
        """``[B, frames, subbands]`` -> ``[B, frames * subbands]``."""
        return _convt_bank(subband_signals, self._bank, self.subbands,
                           self.taps // 2, self.subbands - 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.analysis(x)
