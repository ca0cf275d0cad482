"""Training losses (counterpart of ``waveverify_tpu/losses.py``).

- multi-scale STFT: L1 on ``log10(clamp(mag, 1e-5)^2)`` plus L1 on the
  magnitude, windows (2048, 512), hop w / 4;
- mel: seven scales, ``log10(clamp(mel, 1e-5)^pow)``, the slaney-norm mel
  bank (:func:`mel_filterbank`, built in numpy as the JAX package builds
  it);
- LSGAN discriminator and generator terms over the ensemble's logit maps,
  L1 feature matching, and a WGAN-GP gradient penalty: a second-order
  gradient through the discriminator (``torch.autograd.grad`` with
  ``create_graph=True``), at interpolation weights ``alpha`` the caller
  draws;
- BCE-with-logits localization and decoding losses.

Audio is ``[B, T]``; detector logits ``[B, T, nbits]``; masks ``[B, T]``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveverify_torch.ops.dsp import stft
from waveverify_torch.ops.uploads import device_const

DiscApply = Callable[[torch.Tensor], List[List[torch.Tensor]]]


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with the JAX package's derivative at 0, which is 1
    (``torch.abs`` has 0): at an exact tie, as a generator whose output is
    exactly zero makes (``w == audio``), the step then equals JAX's."""
    return torch.where(x >= 0, x, -x)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(_abs(x - y))


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(x - y))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    reduce: bool = True) -> torch.Tensor:
    """Numerically stable BCE with logits (mean when ``reduce``)."""
    out = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    return torch.mean(out) if reduce else out


def sisdr_loss(estimate: torch.Tensor, reference: torch.Tensor,
               zero_mean: bool = True, clip_min: Optional[float] = None,
               eps: float = 1e-8) -> torch.Tensor:
    """Negative SI-SDR in dB, averaged over the batch."""
    if zero_mean:
        estimate = estimate - torch.mean(estimate, dim=-1, keepdim=True)
        reference = reference - torch.mean(reference, dim=-1, keepdim=True)
    dot = torch.sum(estimate * reference, dim=-1, keepdim=True)
    energy = torch.sum(reference**2, dim=-1, keepdim=True) + eps
    target = dot * reference / energy
    noise = estimate - target
    ratio = ((torch.sum(target**2, dim=-1) + eps)
             / (torch.sum(noise**2, dim=-1) + eps))
    sdr = -10.0 * torch.log10(ratio)
    if clip_min is not None:
        sdr = torch.clamp(sdr, min=clip_min)
    return torch.mean(sdr)


def _magnitude(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    re, im = stft(x, n_fft, hop)
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-12))


def _log_l1(xm: torch.Tensor, ym: torch.Tensor, clamp_eps: float,
            pow: float) -> torch.Tensor:
    return l1_loss(torch.log10(torch.clamp(xm, min=clamp_eps) ** pow),
                   torch.log10(torch.clamp(ym, min=clamp_eps) ** pow))


def multi_scale_stft_loss(
    x: torch.Tensor, y: torch.Tensor,
    window_lengths: Sequence[int] = (2048, 512),
    clamp_eps: float = 1e-5, mag_weight: float = 1.0, log_weight: float = 1.0,
    pow: float = 2.0,
) -> torch.Tensor:
    loss = x.new_zeros(())
    for w in window_lengths:
        xm = _magnitude(x, w, w // 4)
        ym = _magnitude(y, w, w // 4)
        if log_weight > 0:
            loss = loss + log_weight * _log_l1(xm, ym, clamp_eps, pow)
        if mag_weight > 0:
            loss = loss + mag_weight * l1_loss(xm, ym)
    return loss


@lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-style mel filterbank ``[n_mels, n_fft // 2 + 1]``
    (``librosa.filters.mel`` defaults: htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sample_rate / 2.0
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / np.maximum(fdiff[:-1, None], 1e-10)
    upper = ramps[2:] / np.maximum(fdiff[1:, None], 1e-10)
    weights = np.maximum(0, np.minimum(lower, upper))
    # slaney norm: scale by 2 / bandwidth
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _mel_basis(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """:func:`mel_filterbank` transposed, ``[n_fft // 2 + 1, n_mels]``."""
    return mel_filterbank(sample_rate, n_fft, n_mels).T.copy()


def mel_spectrogram_loss(
    x: torch.Tensor, y: torch.Tensor, sample_rate: int = 16000,
    n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
    window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
    clamp_eps: float = 1e-5, mag_weight: float = 0.0, log_weight: float = 1.0,
    pow: float = 1.0,
) -> torch.Tensor:
    loss = x.new_zeros(())
    for nm, w in zip(n_mels, window_lengths):
        fb_t = device_const(_mel_basis, sample_rate, w, nm, like=x)
        xm = _magnitude(x, w, w // 4) @ fb_t  # [B, frames, n_mels]
        ym = _magnitude(y, w, w // 4) @ fb_t
        if log_weight > 0:
            loss = loss + log_weight * _log_l1(xm, ym, clamp_eps, pow)
        if mag_weight > 0:
            loss = loss + mag_weight * l1_loss(xm, ym)
    return loss


def gradient_penalty(disc_apply: DiscApply, fake: torch.Tensor,
                     real: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """WGAN-GP: mean over the batch of (||d critic / d x|| - 1)^2 at
    ``alpha * real + (1 - alpha) * fake``, ``alpha`` ``[B]``; the critic is
    the sum of the logit maps. Differentiable in the discriminator's
    parameters (second order)."""
    interp = (alpha[:, None] * real + (1 - alpha[:, None]) * fake).detach()
    interp.requires_grad_(True)
    critic = sum(torch.sum(maps[-1]) for maps in disc_apply(interp))
    (grads,) = torch.autograd.grad(critic, interp, create_graph=True)
    gnorm = torch.sqrt(torch.sum(torch.square(grads.reshape(grads.shape[0], -1)),
                                 dim=1) + 1e-12)
    return torch.mean(torch.square(gnorm - 1.0))


def discriminator_loss(
    disc_apply: DiscApply, fake: torch.Tensor, real: torch.Tensor,
    alpha: Optional[torch.Tensor] = None, gp_weight: float = 10.0,
) -> torch.Tensor:
    """LSGAN discriminator loss, plus ``gp_weight`` times the gradient
    penalty when ``alpha`` is given. ``fake`` is detached."""
    fake = fake.detach()
    d_fake = disc_apply(fake)
    d_real = disc_apply(real)
    loss_d = real.new_zeros(())
    for f_maps, r_maps in zip(d_fake, d_real):
        loss_d = loss_d + torch.mean(torch.square(f_maps[-1]))
        loss_d = loss_d + torch.mean(torch.square(1.0 - r_maps[-1]))
    if alpha is not None:
        loss_d = loss_d + gp_weight * gradient_penalty(disc_apply, fake, real,
                                                       alpha)
    return loss_d


def generator_loss(disc_apply: DiscApply, fake: torch.Tensor,
                   real: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LSGAN generator loss, L1 feature matching). conf/base.yml gives
    feature matching no weight, so it is returned for the log only."""
    d_fake = disc_apply(fake)
    d_real = disc_apply(real.detach())
    loss_g = fake.new_zeros(())
    for f_maps in d_fake:
        loss_g = loss_g + torch.mean(torch.square(1.0 - f_maps[-1]))
    loss_feat = fake.new_zeros(())
    for f_maps, r_maps in zip(d_fake, d_real):
        for fm, rm in zip(f_maps[:-1], r_maps[:-1]):
            loss_feat = loss_feat + torch.mean(_abs(fm - rm))
    return loss_g, loss_feat


def localization_loss(locator_logits: torch.Tensor,
                      presence_mask: torch.Tensor) -> torch.Tensor:
    """BCE of the locator's logits ``[B, T]`` (or ``[B, T, 1]``) against the
    presence mask ``[B, T]``."""
    if locator_logits.dim() == 3:
        locator_logits = locator_logits[..., 0]
    return bce_with_logits(locator_logits, presence_mask)


def decoding_loss(detector_logits: torch.Tensor, presence_mask: torch.Tensor,
                  message: torch.Tensor,
                  bit_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE of the bit logits ``[B, T, W]`` against the message ``[B, W]``
    broadcast over time and zeroed where the mask is 0. ``bit_mask`` ``[W]``
    weights the bits, normalised by the number of active bits."""
    target = message[:, None, :] * presence_mask[:, :, None]
    if bit_mask is None:
        return bce_with_logits(detector_logits, target)
    el = bce_with_logits(detector_logits, target, reduce=False)
    denom = el.shape[0] * el.shape[1] * torch.clamp(torch.sum(bit_mask), min=1.0)
    return torch.sum(el * bit_mask[None, None, :]) / denom


def decoding_loss_bits(detector_logits: torch.Tensor,
                       presence_mask: Optional[torch.Tensor],
                       message: torch.Tensor,
                       bit_mask: Optional[torch.Tensor] = None, *,
                       n_valid: Optional[torch.Tensor] = None,
                       scale: float = 1.0) -> torch.Tensor:
    """BCE on the masked time-mean logit per bit (the decision quantity).
    ``presence_mask`` None means every frame.

    With a presence mask the loss is a ratio of sums over the batch: the
    sum over samples with a watermarked frame, over their count.
    ``n_valid`` replaces that count and ``scale`` multiplies the sum: a
    data-parallel step passes the global batch's count and its number of
    ranks, so that the mean over the ranks of the loss, and of its
    gradient, is the global batch's (``train.step.global_decoding_loss_bits``)."""
    if presence_mask is None:
        z = torch.mean(detector_logits, dim=1)
        if bit_mask is None:
            return bce_with_logits(z, message)
        el = bce_with_logits(z, message, reduce=False)
        return (torch.sum(el * bit_mask[None, :])
                / (el.shape[0] * torch.clamp(torch.sum(bit_mask), min=1.0)))
    m = presence_mask[:, :, None]
    denom = torch.sum(m, dim=1)  # [B, 1]
    z = torch.sum(detector_logits * m, dim=1) / torch.clamp(denom, min=1.0)
    valid = (denom > 0).to(z.dtype)
    per_bit = bce_with_logits(z, message, reduce=False) * valid * scale
    if n_valid is None:
        n_valid = torch.sum(valid)
    if bit_mask is None:
        return torch.sum(per_bit) / torch.clamp(n_valid * z.shape[-1], min=1.0)
    return (torch.sum(per_bit * bit_mask[None, :])
            / torch.clamp(n_valid * torch.sum(bit_mask), min=1.0))
