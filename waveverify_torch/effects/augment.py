"""Localization and sequence augmentations of the training forward
(counterpart of ``waveverify_tpu/effects/augment.py``).

The functions are deterministic: they take their random draws as tensors
(made by :func:`draw_localization` and :func:`draw_sequence` from a
``torch.Generator``, or by a test from the JAX package's key chain), so a
rematerialised segment recomputes exactly what its forward computed.

- localization: per item, ``n_modify`` (20%) of the 0.1 s segments, the
  lowest-ranked random scores, are reverted to the original (action draw
  < 0.33), zeroed (< 0.66) or replaced by another item's original; the
  presence mask is 0 on them;
- sequence: one whole-batch transform, chosen by a uniform draw ``u``:
  reverse (u < 0.3), circular shift by ``shift`` (< 0.7), shuffle of the
  0.5 s segments by ``perm`` (< 1.0, when T holds two or more whole
  segments), else identity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

TARGET_AUGMENTATION_RATIO = 0.20
ORIGINAL_REVERT_PROB = 0.33
ZERO_REPLACE_PROB = 0.66
REVERSE_PROBABILITY = 0.3
CIRCULAR_SHIFT_PROBABILITY = 0.4
SHUFFLE_PROBABILITY = 0.3
DEFAULT_SEGMENT_DURATION = 0.5  # seconds, shuffle segments


def localization_segments(t: int, sample_rate: int = 16000,
                          window_duration: float = 0.1) -> Tuple[int, int]:
    """(segment length, segment count) of a clip of ``t`` samples."""
    seg_len = int(window_duration * sample_rate)
    return seg_len, -(-t // seg_len)


def draw_localization(generator: torch.Generator, b: int, t: int,
                      sample_rate: int = 16000, window_duration: float = 0.1
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores, probs ``[B, S]`` uniform, donor offsets ``[B, S]`` in
    [1, max(B, 2)))."""
    _, n_segs = localization_segments(t, sample_rate, window_duration)
    scores = torch.rand((b, n_segs), generator=generator)
    probs = torch.rand((b, n_segs), generator=generator)
    offset = torch.randint(1, max(b, 2), (b, n_segs), generator=generator)
    return scores, probs, offset


def localization_augmentation(
    original: torch.Tensor, watermarked: torch.Tensor, scores: torch.Tensor,
    probs: torch.Tensor, offset: torch.Tensor, sample_rate: int = 16000,
    window_duration: float = 0.1, donors: Optional[torch.Tensor] = None,
    row0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(augmented watermarked, presence mask, updated original), all
    ``[B, T]``. ``donors``: the clean audio of the global batch whose rows
    ``[row0, row0 + B)`` these are (one rank's share); a cross substitution
    takes its segment from the global batch's item ``(row + offset) %
    len(donors)``, as one program over the global batch does. None:
    ``original`` is the whole batch."""
    b, t = watermarked.shape
    pool = original if donors is None else donors
    nb = pool.shape[0]
    seg_len, n_segs = localization_segments(t, sample_rate, window_duration)
    n_modify = int(n_segs * TARGET_AUGMENTATION_RATIO)
    dev = watermarked.device
    ranks = torch.argsort(torch.argsort(scores, dim=1, stable=True), dim=1,
                          stable=True)
    seg_modified = ranks < n_modify
    act_revert = probs < ORIGINAL_REVERT_PROB
    act_zero = (probs >= ORIGINAL_REVERT_PROB) & (probs < ZERO_REPLACE_PROB)
    act_cross = probs >= ZERO_REPLACE_PROB
    if nb < 2:
        # cross substitution needs a second item; the segment stays
        # watermarked
        act_cross = torch.zeros_like(act_cross)
        seg_modified = seg_modified & ~(probs >= ZERO_REPLACE_PROB)
    donor = (row0 + torch.arange(b, device=dev)[:, None] + offset) % max(nb, 1)

    seg_of_sample = torch.arange(t, device=dev) // seg_len
    modified = seg_modified[:, seg_of_sample]
    revert = act_revert[:, seg_of_sample] & modified
    zero = act_zero[:, seg_of_sample] & modified
    cross = act_cross[:, seg_of_sample] & modified
    donor_audio = pool[donor[:, seg_of_sample],
                           torch.arange(t, device=dev)[None, :]]

    augmented = torch.where(revert, original, watermarked)
    augmented = torch.where(zero, torch.zeros_like(augmented), augmented)
    augmented = torch.where(cross, donor_audio, augmented)
    updated_original = torch.where(zero, torch.zeros_like(original), original)
    updated_original = torch.where(cross, donor_audio, updated_original)
    presence = (~modified).to(watermarked.dtype)
    return augmented, presence, updated_original


def shuffle_segments(t: int, sample_rate: int = 16000) -> int:
    """Number of 0.5 s segments the shuffle permutes (1: no shuffle)."""
    seg = int(DEFAULT_SEGMENT_DURATION * sample_rate)
    return t // seg if t >= 2 * seg and t % seg == 0 else 1


def draw_sequence(generator: torch.Generator, t: int, sample_rate: int = 16000
                  ) -> Tuple[float, int, torch.Tensor]:
    """(u uniform, shift in [1, t), perm of the shuffle segments)."""
    u = float(torch.rand((), generator=generator))
    shift = int(torch.randint(1, t, (), generator=generator))
    perm = torch.randperm(shuffle_segments(t, sample_rate), generator=generator)
    return u, shift, perm


def sequence_augmentation(
    watermarked: torch.Tensor, updated_original: torch.Tensor,
    mask: torch.Tensor, u: float, shift: int, perm: torch.Tensor,
    sample_rate: int = 16000,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One transform applied alike to (watermarked, original, mask)."""
    b, t = watermarked.shape
    seg = int(DEFAULT_SEGMENT_DURATION * sample_rate)
    n_segs = shuffle_segments(t, sample_rate)
    xs = (watermarked, updated_original, mask)
    if u < REVERSE_PROBABILITY:
        return tuple(torch.flip(x, dims=(1,)) for x in xs)
    if u < REVERSE_PROBABILITY + CIRCULAR_SHIFT_PROBABILITY:
        return tuple(torch.roll(x, shift, dims=1) for x in xs)
    if u < REVERSE_PROBABILITY + CIRCULAR_SHIFT_PROBABILITY + SHUFFLE_PROBABILITY:
        if n_segs == 1:
            return xs
        idx = perm.to(watermarked.device)
        return tuple(x.reshape(b, n_segs, seg)[:, idx, :].reshape(b, t)
                     for x in xs)
    return xs
