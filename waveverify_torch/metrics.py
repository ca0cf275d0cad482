"""Evaluation metrics (counterpart of ``waveverify_tpu/metrics.py``).

BER, MIoU and SI-SNR are tensor code that runs on the audio's device.
STOI and PESQ are host-side and eval-only: STOI prefers ``pystoi`` when it
is installed and otherwise uses :mod:`waveverify_torch.quality`; PESQ is
NaN when the ``pesq`` library is absent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_BER_THRESHOLD = 0.5
EPSILON = 1e-8


def ber(decoded_logits: torch.Tensor, original_bits: torch.Tensor,
        presence_mask: Optional[torch.Tensor] = None,
        threshold: float = DEFAULT_BER_THRESHOLD,
        per_sample: bool = False) -> torch.Tensor:
    """Mask-aware bit error rate.

    decoded_logits ``[B, T, W]`` (time-major, as in the JAX package);
    original_bits ``[B, W]``; presence_mask ``[B, T]`` or ``[B, T, 1]`` with
    1 = watermarked. Sigmoid, masked time-average, threshold, then the
    error fraction over bits of items with at least one valid step."""
    b, _, w = decoded_logits.shape
    probs = torch.sigmoid(decoded_logits)
    if presence_mask is not None:
        if presence_mask.dim() == 3:
            presence_mask = presence_mask[..., 0]
        mask = presence_mask[:, :, None].to(probs.dtype)  # [B, T, 1]
        valid_bits = (torch.sum(mask, dim=1) > 0).expand(b, w)
        avg_probs = torch.sum(probs * mask, dim=1) / (torch.sum(mask, dim=1) + EPSILON)
    else:
        valid_bits = torch.ones((b, w), dtype=torch.bool, device=probs.device)
        avg_probs = torch.mean(probs, dim=1)
    decoded_bits = (avg_probs >= threshold).float()
    errors = (decoded_bits != original_bits.float()) & valid_bits
    if per_sample:
        n_valid = torch.sum(valid_bits, dim=1)
        rate = torch.sum(errors, dim=1) / torch.clamp(n_valid, min=1)
        return torch.where(n_valid > 0, rate, torch.zeros_like(rate))
    n_valid = torch.sum(valid_bits)
    rate = torch.sum(errors) / torch.clamp(n_valid, min=1)
    return torch.where(n_valid > 0, rate, torch.zeros_like(rate))


def evaluate_ber(decoded_probs: torch.Tensor, original_bits: torch.Tensor,
                 threshold: float = DEFAULT_BER_THRESHOLD) -> torch.Tensor:
    """BER of probability (not logit) inputs of one shape: binarise both at
    ``threshold`` and return 1 - accuracy."""
    if decoded_probs.shape != original_bits.shape:
        raise ValueError(f"Shape mismatch: decoded={tuple(decoded_probs.shape)}, "
                         f"original={tuple(original_bits.shape)}")
    decoded = decoded_probs >= threshold
    original = original_bits >= threshold
    return 1.0 - torch.mean((decoded == original).float())


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boolean masks along the last axis; 1 where both are empty."""
    inter = torch.sum(a & b, dim=-1)
    union = torch.sum(a | b, dim=-1)
    return torch.where(union == 0, (inter == 0).float(),
                       inter / torch.clamp(union, min=1))


def miou(predicted_mask: torch.Tensor, ground_truth_mask: torch.Tensor,
         per_sample: bool = False) -> torch.Tensor:
    """Mean of the foreground and background IoU of binary masks (> 0.5).
    Masks ``[B, T]`` or ``[B, T, 1]``; ``per_sample`` gives ``[B]``, else one
    value over the flattened batch."""
    if predicted_mask.dim() == 3:
        predicted_mask = predicted_mask[..., 0]
    if ground_truth_mask.dim() == 3:
        ground_truth_mask = ground_truth_mask[..., 0]
    pred = predicted_mask > 0.5
    gt = ground_truth_mask > 0.5
    if not per_sample:
        pred, gt = pred.reshape(-1), gt.reshape(-1)
    return (_iou(pred, gt) + _iou(~pred, ~gt)) / 2.0


def sisnr(estimate: torch.Tensor, reference: torch.Tensor,
          zero_mean: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB, mean over the batch. Inputs ``[B, T]`` or
    ``[B, T, 1]``."""
    if estimate.dim() == 3:
        estimate = estimate[..., 0]
    if reference.dim() == 3:
        reference = reference[..., 0]
    if zero_mean:
        estimate = estimate - torch.mean(estimate, dim=-1, keepdim=True)
        reference = reference - torch.mean(reference, dim=-1, keepdim=True)
    dot = torch.sum(estimate * reference, dim=-1, keepdim=True)
    ref_energy = torch.sum(reference**2, dim=-1, keepdim=True) + eps
    target = dot * reference / ref_energy
    noise = estimate - target
    ratio = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return torch.mean(10.0 * torch.log10(ratio))


def stoi(estimate: np.ndarray, reference: np.ndarray,
         sample_rate: int = 16000) -> float:
    """Short-time objective intelligibility of one clip (host)."""
    try:
        from pystoi import stoi as _stoi  # type: ignore
    except ImportError:
        from waveverify_torch.quality import native_stoi

        return float(native_stoi(estimate, reference, sample_rate))
    return float(_stoi(np.asarray(reference).ravel(), np.asarray(estimate).ravel(),
                       sample_rate, extended=False))


def pesq(estimate: np.ndarray, reference: np.ndarray,
         sample_rate: int = 16000, band: str = "wb") -> float:
    """PESQ of one clip through the ``pesq`` library (host); NaN when the
    library is absent."""
    try:
        from pesq import pesq as _pesq  # type: ignore
    except ImportError:
        return float("nan")
    return float(_pesq(sample_rate, np.asarray(reference).ravel(),
                       np.asarray(estimate).ravel(), band))
