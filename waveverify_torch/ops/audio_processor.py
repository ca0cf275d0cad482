"""Audio and mask length adjustment (``AudioProcessor``; counterpart of
``waveverify_tpu/ops/audio_processor.py``).

Every function acts on the last axis, takes any leading shape and keeps
the input's device. The modes match ``torch.nn.functional.interpolate``:
``stretch`` is ``mode='linear', align_corners=False``, ``nearest`` is
``mode='nearest'`` (floor rule), ``nearest-exact`` is ``mode='nearest-exact'``
(round rule); a mask under ``stretch`` is re-binarised at ``> 0.5``. The
positions are computed in f32, as the JAX package computes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_AUDIO_MODES = ("pad_truncate", "stretch", "nearest")
_MASK_MODES = ("pad_truncate", "stretch", "nearest-exact")


def _pad_truncate(x: torch.Tensor, target_length: int) -> torch.Tensor:
    cur = x.shape[-1]
    if cur > target_length:
        return x[..., :target_length]
    return F.pad(x, (0, target_length - cur))


def _linear(x: torch.Tensor, target_length: int) -> torch.Tensor:
    """``F.interpolate(mode='linear', align_corners=False)``."""
    cur = x.shape[-1]
    pos = (torch.arange(target_length, dtype=torch.float32, device=x.device)
           + 0.5) * (cur / target_length) - 0.5
    pos = torch.clamp(pos, 0.0, cur - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=cur - 1)
    w = (pos - lo).to(x.dtype)
    return x[..., lo] * (1 - w) + x[..., hi] * w


def _nearest(x: torch.Tensor, target_length: int, exact: bool) -> torch.Tensor:
    cur = x.shape[-1]
    i = torch.arange(target_length, dtype=torch.float32, device=x.device)
    # round rule (nearest-exact) or floor rule (legacy nearest)
    idx = torch.floor((i + 0.5 if exact else i) * (cur / target_length))
    return x[..., torch.clamp(idx.long(), 0, cur - 1)]


def _check(target_length, mode: str, modes) -> None:
    if not isinstance(target_length, int) or target_length <= 0:
        raise ValueError(
            f"Target length must be a positive integer, got {target_length}")
    if mode not in modes:
        raise ValueError(f"Unknown mode: {mode!r}. Valid: {modes}")


def adjust_audio_length(tensor: torch.Tensor, target_length: int,
                        mode: str = "pad_truncate") -> torch.Tensor:
    """Audio at ``target_length`` samples along the last axis: cut or
    zero-padded, stretched linearly, or resampled by the nearest sample.
    Returns ``tensor`` itself when it already has that length."""
    _check(target_length, mode, _AUDIO_MODES)
    if tensor.shape[-1] == target_length:
        return tensor
    if mode == "pad_truncate":
        return _pad_truncate(tensor, target_length)
    if mode == "stretch":
        return _linear(tensor, target_length)
    return _nearest(tensor, target_length, exact=False)


def adjust_mask_length(mask: torch.Tensor, target_length: int,
                       mode: str = "pad_truncate") -> torch.Tensor:
    """A binary presence mask at ``target_length`` samples, kept binary:
    ``stretch`` re-binarises at > 0.5, ``nearest-exact`` uses the round rule
    so that single-sample features survive. Returns ``mask`` itself when it
    already has that length."""
    _check(target_length, mode, _MASK_MODES)
    if mask.shape[-1] == target_length:
        return mask
    if mode == "pad_truncate":
        return _pad_truncate(mask, target_length)
    m = mask.float()
    if mode == "stretch":
        return (_linear(m, target_length) > 0.5).to(mask.dtype)
    return _nearest(m, target_length, exact=True).to(mask.dtype)


class AudioProcessor:
    """The reference's class surface over the two functions."""

    adjust_audio_length = staticmethod(adjust_audio_length)
    adjust_mask_length = staticmethod(adjust_mask_length)
