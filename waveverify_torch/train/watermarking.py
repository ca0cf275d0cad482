"""The composite forward passes of training and validation (counterpart of
``waveverify_tpu/train/watermarking.py``).

Every random draw of a step is made first, into :class:`Draws`, and the
forwards take it as an argument. ``torch.utils.checkpoint`` replays the
global RNG, not an explicit ``torch.Generator``, so a draw made inside a
rematerialised segment would differ in the recompute; drawn beforehand,
the recompute sees the same values. A test builds the same ``Draws`` from
the JAX package's key chain.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from waveverify_torch.effects.augment import (
    draw_localization,
    draw_sequence,
    localization_augmentation,
    sequence_augmentation,
)
from waveverify_torch.effects.effects import (
    DEFAULT_EVAL_EFFECTS,
    RANDOM_EFFECTS,
    AudioEffects,
    EffectBank,
    draw_effect,
    effect_fn,
    move_draws,
    random_indices,
    take_rows,
)
from waveverify_torch.metrics import ber, miou
from waveverify_torch.models import WatermarkModels


@dataclass
class Draws:
    """The random draws of one step.

    loc_scores, loc_probs, loc_offset ``[B, S]``: the localization
    augmentation's segment scores, action draws and donor offsets;
    seq_u, seq_shift, seq_perm: the sequence augmentation's choice, shift
    and segment permutation; fx: the draws of each random branch of the
    bank (training) or each random effect of the sweep (validation), one
    dict of whole-batch draws each (``effects.draw_effect``), or under the
    bank's "scan" dispatch one dict per sample (``EffectBank.draw_specs``);
    jitter, jitter_clean ``[B]``: the sub-hop rolls (None when off);
    gp_alpha ``[B]``: the gradient penalty's interpolation weights (None in
    validation); per_sample: whether ``fx`` holds one entry per sample;
    row0: the global batch row of the first row (:meth:`rows`)."""

    loc_scores: torch.Tensor
    loc_probs: torch.Tensor
    loc_offset: torch.Tensor
    seq_u: float
    seq_shift: int
    seq_perm: torch.Tensor
    fx: List[Dict[str, Any]]
    jitter: Optional[torch.Tensor] = None
    jitter_clean: Optional[torch.Tensor] = None
    gp_alpha: Optional[torch.Tensor] = None
    per_sample: bool = False
    row0: int = 0

    def to(self, device: torch.device) -> "Draws":
        return dataclasses.replace(self, **{
            f.name: move_draws(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})

    def rows(self, lo: int, hi: int) -> "Draws":
        """Rows ``[lo, hi)`` of a global batch's draws, for the rank that
        holds those rows (the JAX package's replicated key: every rank
        draws the global batch and keeps its slice). Batch-shaped draws are
        sliced, and so are per-sample effect draws; a branch's whole-batch
        effect draws keep their 0-d entries (one draw per call, shared by
        the branch's samples on every rank); the sequence augmentation's
        draws are the whole batch's and stay as they are."""
        rows = torch.arange(lo, hi)

        def cut(t):
            return None if t is None else t[lo:hi]

        fx = (self.fx[lo:hi] if self.per_sample
              else [take_rows(d, rows) for d in self.fx])
        return dataclasses.replace(
            self, loc_scores=cut(self.loc_scores), loc_probs=cut(self.loc_probs),
            loc_offset=cut(self.loc_offset), fx=fx, jitter=cut(self.jitter),
            jitter_clean=cut(self.jitter_clean), gp_alpha=cut(self.gp_alpha),
            row0=self.row0 + lo)


def draw(generator: torch.Generator, b: int, t: int,
         random_effects: Sequence[Tuple[str, Dict]] = (),
         sample_rate: int = 16000, window_duration: float = 0.1,
         jitter_hop: int = 0, gp: bool = True,
         per_sample: bool = False) -> Draws:
    """Every draw of a step from a CPU ``generator``, on the CPU;
    ``random_effects`` lists the (name, params) whose draws ``fx`` holds
    (``EffectBank.draw_specs``, or the sweep's random effects), each drawn
    for the whole batch, or with ``per_sample`` (the bank's "scan"
    dispatch: one entry per sample) for one row, an effect without
    randomness drawing nothing."""
    scores, probs, offset = draw_localization(generator, b, t, sample_rate,
                                              window_duration)
    u, shift, perm = draw_sequence(generator, t, sample_rate)
    fx = [draw_effect(name, params, generator, 1 if per_sample else b, t)
          if name in RANDOM_EFFECTS else {}
          for name, params in random_effects]
    jitter = jitter_clean = None
    if jitter_hop > 0:
        jitter = torch.randint(0, jitter_hop, (b,), generator=generator)
        jitter_clean = torch.randint(0, jitter_hop, (b,), generator=generator)
    alpha = torch.rand((b,), generator=generator) if gp else None
    return Draws(scores, probs, offset, u, shift, perm, fx, jitter,
                 jitter_clean, alpha, per_sample)


def _sub_hop_roll(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-sample circular roll of ``[B, T]`` by ``r`` ``[B]`` samples."""
    t = x.shape[1]
    idx = (torch.arange(t, device=x.device)[None, :] - r[:, None]) % t
    return torch.gather(x, 1, idx)


def _maybe_checkpoint(remat: bool, fn, *args):
    if not remat:
        return fn(*args)
    # no draw happens inside, so the RNG state need not be replayed
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward_train(
    models: WatermarkModels, audio: torch.Tensor, msg: torch.Tensor,
    effect_idx, bank: EffectBank, draws: Draws, sample_rate: int = 16000,
    window_duration: float = 0.1, remat: bool = True,
    clean_detector: bool = False, jitter_hop: int = 0,
    lowband_cutoff: float = 0.0, donors: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The training forward: generator, augmentations, the bank's attacks,
    detector and locator.

    audio ``[B, T]``, msg ``[B, nbits]`` in {0, 1}, effect_idx ``[B]`` bank
    branch indices (host). Returns the differentiable outputs: residual
    (the raw generator output the discriminator trains on), watermarked,
    mask (ground-truth presence), detector_logits ``[B, T, nbits]``,
    locator_logits ``[B, T]``, updated_original; and
    detector_logits_clean / _lowband when those paths are on. With
    ``remat`` the three networks and the augment-and-attack segment are
    recomputed in the backward pass. ``donors``: the clean audio of the
    global batch whose rows ``draws.row0`` on ``audio`` holds, from which
    the localization's cross substitution takes its segments (None:
    ``audio`` is the whole batch)."""
    residual = _maybe_checkpoint(remat, models.apply_generator, audio, msg)
    watermarked = residual + audio

    def augment_and_attack(watermarked, audio):
        augmented, mask, updated_original = localization_augmentation(
            audio, watermarked, draws.loc_scores, draws.loc_probs,
            draws.loc_offset, sample_rate, window_duration, donors=donors,
            row0=draws.row0)
        augmented, updated_original, mask = sequence_augmentation(
            augmented, updated_original, mask, draws.seq_u, draws.seq_shift,
            draws.seq_perm, sample_rate)
        fx_audio, mask = bank.apply(augmented, mask, effect_idx, draws.fx)
        if jitter_hop > 0:
            fx_audio = _sub_hop_roll(fx_audio, draws.jitter)
            mask = _sub_hop_roll(mask, draws.jitter)
        return fx_audio, mask, updated_original

    fx_audio, mask, updated_original = _maybe_checkpoint(
        remat, augment_and_attack, watermarked, audio)
    out = {
        "residual": residual,
        "watermarked": watermarked,
        "mask": mask,
        "detector_logits": _maybe_checkpoint(remat, models.apply_detector,
                                             fx_audio),
        "locator_logits": _maybe_checkpoint(remat, models.apply_locator,
                                            fx_audio),
        "updated_original": updated_original,
    }
    if clean_detector or lowband_cutoff > 0:
        # un-augmented, un-attacked read path: the target is the message on
        # every frame
        clean_in = (_sub_hop_roll(watermarked, draws.jitter_clean)
                    if jitter_hop > 0 else watermarked)
        if clean_detector:
            out["detector_logits_clean"] = _maybe_checkpoint(
                remat, models.apply_detector, clean_in)
        if lowband_cutoff > 0:
            lb_in, _ = AudioEffects.lowpass_filter(
                clean_in, None, None, cutoff_freq=lowband_cutoff,
                sample_rate=sample_rate)
            out["detector_logits_lowband"] = _maybe_checkpoint(
                remat, models.apply_detector, lb_in)
    return out


@torch.no_grad()
def forward_audio_sample(models: WatermarkModels, audio: torch.Tensor,
                         msg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(residual, watermarked): no augmentation, no gradient."""
    residual = models.apply_generator(audio, msg)
    return residual, residual + audio


def eval_random_effects(eval_effects: Sequence[Tuple[str, Dict]]
                        ) -> List[Tuple[str, Dict]]:
    """The sweep's effects that take drawn randomness, in order: what
    ``draws.fx`` holds in validation."""
    return [eval_effects[i] for i in random_indices(eval_effects)]


@torch.no_grad()
def forward_valid(
    models: WatermarkModels, audio: torch.Tensor, msg: torch.Tensor,
    draws: Draws, eval_effects: Optional[Sequence[Tuple[str, Dict]]] = None,
    sample_rate: int = 16000, window_duration: float = 0.1,
) -> Dict[str, Any]:
    """Validation: the watermarked audio goes through the localization and
    sequence augmentations (so MIoU's ground truth is a spliced mask), then
    each sweep effect; detect and locate each. ``draws.fx`` holds the draws
    of each effect of :func:`eval_random_effects`. Returns
    ``{"residual", "watermarked", "effects": {name: {ber, miou,
    detector_logits, locator_logits, mask}}}``."""
    if eval_effects is None:
        eval_effects = DEFAULT_EVAL_EFFECTS
    residual = models.apply_generator(audio, msg)
    watermarked = residual + audio
    augmented, gt_mask, updated_original = localization_augmentation(
        audio, watermarked, draws.loc_scores, draws.loc_probs,
        draws.loc_offset, sample_rate, window_duration)
    augmented, updated_original, gt_mask = sequence_augmentation(
        augmented, updated_original, gt_mask, draws.seq_u, draws.seq_shift,
        draws.seq_perm, sample_rate)
    random = random_indices(eval_effects)
    results: Dict[str, Any] = {}
    for i, (name, params) in enumerate(eval_effects):
        kw = dict(params)
        if i in random:
            kw.update(draws.fx[random.index(i)])
        fx, mask = effect_fn(name)(augmented, gt_mask, None,
                                   sample_rate=sample_rate, **kw)
        mask = gt_mask if mask is None else mask
        det = models.apply_detector(fx)
        loc = models.apply_locator(fx)
        tag = name if name not in results else f"{name}_{i}"
        results[tag] = {
            "ber": ber(det, msg, mask),
            "miou": miou(torch.sigmoid(loc), mask),
            "detector_logits": det,
            "locator_logits": loc,
            "mask": mask,
        }
    return {"residual": residual, "watermarked": watermarked,
            "effects": results}
