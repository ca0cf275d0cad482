"""Self-contained quality metrics (host-side, eval-only).

The reference gates STOI on the optional ``pystoi`` package
(reference scripts/evaluate.py:65-144) and returns nothing useful without
it. This module implements the standard STOI measure from its published
definition (Taal, Hendriks, Heusdens, Jensen, "An Algorithm for
Intelligibility Prediction of Time-Frequency Weighted Noisy Speech",
IEEE TASLP 2011) in plain numpy, so the eval sweep always reports a real
intelligibility number. When ``pystoi`` happens to be installed,
:func:`waveverify_torch.metrics.stoi` still prefers it; this is the
always-available fallback implementing the same algorithm:

1. resample both signals to 10 kHz;
2. remove frames whose clean-signal energy is > 40 dB below the loudest
   frame (256-sample Hann frames, hop 128), overlap-add reconstruct;
3. 512-point STFT -> 15 one-third-octave band magnitudes from 150 Hz;
4. over 384 ms segments (30 frames): normalize the degraded band vectors
   to the clean energy, clip at +/- (1 + 10^(-BETA/20)) with BETA = -15 dB,
   and average the per-band zero-mean correlation coefficients.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

_FS = 10000          # internal analysis rate (Hz)
_N_FRAME = 256       # frame length at 10 kHz (25.6 ms)
_NFFT = 512          # zero-padded FFT size
_NUM_BANDS = 15      # one-third octave bands
_MIN_FREQ = 150.0    # center frequency of the first band (Hz)
_SEG_FRAMES = 30     # frames per analysis segment (384 ms)
_BETA = -15.0        # lower SDR clipping bound (dB)
_DYN_RANGE = 40.0    # silent-frame energy threshold below max (dB)


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == _FS:
        return x
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(_FS, int(fs))
    return resample_poly(x, frac.numerator, frac.denominator)


def _frames(x: np.ndarray, hop: int) -> np.ndarray:
    n = 1 + (len(x) - _N_FRAME) // hop if len(x) >= _N_FRAME else 0
    idx = hop * np.arange(max(n, 0))[:, None] + np.arange(_N_FRAME)[None, :]
    return x[idx] if n > 0 else np.zeros((0, _N_FRAME), x.dtype)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames where the clean signal is silent; overlap-add the rest."""
    hop = _N_FRAME // 2
    w = np.hanning(_N_FRAME + 2)[1:-1]
    xf = _frames(x, hop) * w
    yf = _frames(y, hop) * w
    if xf.shape[0] == 0:
        return x, y
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + np.finfo(float).eps)
    keep = energy - energy.max() + _DYN_RANGE > 0
    xf, yf = xf[keep], yf[keep]
    n_keep = xf.shape[0]
    out_len = (n_keep - 1) * hop + _N_FRAME if n_keep else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_keep):  # eval-only host path; clip counts are tiny
        s = i * hop
        x_out[s:s + _N_FRAME] += xf[i]
        y_out[s:s + _N_FRAME] += yf[i]
    return x_out, y_out


def _third_octave_matrix() -> np.ndarray:
    """[15, NFFT/2+1] 0/1 matrix selecting each band's FFT bins."""
    f = np.linspace(0, _FS, _NFFT + 1)[: _NFFT // 2 + 1]
    obm = np.zeros((_NUM_BANDS, len(f)))
    for k in range(_NUM_BANDS):
        cf = _MIN_FREQ * 2.0 ** (k / 3.0)
        lo = cf / 2.0 ** (1.0 / 6.0)
        hi = cf * 2.0 ** (1.0 / 6.0)
        lo_bin = int(np.argmin((f - lo) ** 2))
        hi_bin = int(np.argmin((f - hi) ** 2))
        obm[k, lo_bin:hi_bin] = 1.0
    return obm


def _band_spectrogram(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    """[15, n_frames] one-third-octave band magnitudes."""
    hop = _N_FRAME // 2
    w = np.hanning(_N_FRAME + 2)[1:-1]
    xf = _frames(x, hop) * w
    spec = np.abs(np.fft.rfft(xf, _NFFT, axis=1)) ** 2  # [n, NFFT/2+1]
    return np.sqrt(obm @ spec.T)


def native_stoi(estimate: np.ndarray, reference: np.ndarray,
                sample_rate: int) -> float:
    """Standard (non-extended) STOI of ``estimate`` against clean
    ``reference``; both 1-D. Returns 1e-5 when not enough active speech
    frames remain for even one 384 ms segment."""
    x = np.asarray(reference, dtype=np.float64).ravel()
    y = np.asarray(estimate, dtype=np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {x.shape} vs {y.shape}")

    x = _resample_to_10k(x, sample_rate)
    y = _resample_to_10k(y, sample_rate)
    x, y = _remove_silent_frames(x, y)

    obm = _third_octave_matrix()
    X = _band_spectrogram(x, obm)  # [15, n]
    Y = _band_spectrogram(y, obm)
    n = X.shape[1]
    if n < _SEG_FRAMES:
        logger.warning("STOI: %d frames after silence removal (<%d); "
                       "returning 1e-5", n, _SEG_FRAMES)
        return 1e-5

    eps = np.finfo(np.float64).eps
    clip = 10.0 ** (-_BETA / 20.0)
    d_sum = 0.0
    n_seg = n - _SEG_FRAMES + 1
    for m in range(n_seg):
        xs = X[:, m:m + _SEG_FRAMES]          # [15, 30]
        ys = Y[:, m:m + _SEG_FRAMES]
        alpha = (np.linalg.norm(xs, axis=1, keepdims=True)
                 / (np.linalg.norm(ys, axis=1, keepdims=True) + eps))
        ys_c = np.minimum(ys * alpha, xs * (1.0 + clip))
        xn = xs - xs.mean(axis=1, keepdims=True)
        yn = ys_c - ys_c.mean(axis=1, keepdims=True)
        xn = xn / (np.linalg.norm(xn, axis=1, keepdims=True) + eps)
        yn = yn / (np.linalg.norm(yn, axis=1, keepdims=True) + eps)
        d_sum += float(np.sum(xn * yn)) / _NUM_BANDS
    return d_sum / n_seg
