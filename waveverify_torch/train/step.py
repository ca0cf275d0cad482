"""One training step and one validation step (counterpart of
``waveverify_tpu/train/step.py``), in the reference's order:

1. one composite forward, its graph kept;
2. the discriminator update, on the detached raw generator output against
   the clean audio: LSGAN plus the gradient penalty, gradients clipped at
   ``MAX_GRADIENT_NORM``;
3. the generator losses against the *updated* discriminator (whose
   parameters take no gradient from them), backward through the kept
   forward;
4. only the generator's gradients clipped; the detector and locator are
   stepped unclipped;
5. per-sample BER and MIoU and per-bit accuracy, for the scheduler.

The training controllers (``train/loop.py``) steer a step through five
optional inputs, with the JAX step's semantics: ``percep_scale`` weighs
the perceptual and adversarial terms (by default the step-indexed ramp of
``LossConfig.warmup_steps``, or 1); ``train_disc`` False skips step 2 and
the adversarial terms of step 3; ``gen_update_scale`` and
``msg_update_scale`` multiply the generator's clipped gradients (all of
them, or the message path's); ``bit_mask`` weighs the bits of every
decoding loss.

The pieces are functions of their own so a caller can time them apart.
Under a profiler each step records them as spans
(:mod:`waveverify_torch.spans`): the root ``train_step`` (``disc_step``
for the split step's first half) and its device phases ``step.forward``
(step 1), ``step.disc`` (step 2), ``step.gen_backward`` (step 3's losses
and backward) and ``step.update`` (steps 4 and 5), one after another on
the stream.

Across the ranks of a process group (``waveverify_torch.parallel``), each
rank steps on its own rows of the global batch and the step computes the
JAX package's global-batch program: the localization's donor rows come
from the global batch; each backward's gradients are averaged over the
ranks before the clip and the gates, so the gradient norms are the global
ones; the decoding-bits loss and the per-bit accuracy take their counts
from global sums; the reported losses, ``train/ber`` and ``train/miou``
are global means. ``per_sample_*`` stay the rank's own rows, which its
effect scheduler selected. Without a group nothing is reduced.

Two other forms of the step, as the JAX package has them: the split step
(:func:`disc_step`, then :func:`train_step` with ``update_disc=False``),
whose discriminator update runs on a no-grad generator forward of its own
before the generator's step; and :func:`train_steps`, K steps in one call
with the controllers' inputs held and the metrics stacked on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from waveverify_torch import parallel, spans
from waveverify_torch.config import LossConfig, TrainConfig
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.losses import (
    decoding_loss,
    decoding_loss_bits,
    discriminator_loss,
    generator_loss,
    l1_loss,
    localization_loss,
    mel_spectrogram_loss,
    multi_scale_stft_loss,
)
from waveverify_torch.metrics import ber, miou, sisnr
from waveverify_torch.train.state import TrainState, in_msg_path
from waveverify_torch.train.watermarking import Draws, forward_train, forward_valid

MAX_GRADIENT_NORM = 10.0


def step_ramp(step: int, loss_cfg: LossConfig) -> float:
    """The step-indexed perceptual ramp, ``init_scale ** (1 - clip(step /
    warmup_steps, 0, 1))`` in f32 as the JAX step traces it; 1 without
    ``warmup_steps``."""
    if loss_cfg.warmup_steps <= 0:
        return 1.0
    frac = torch.clamp(torch.tensor(step, dtype=torch.float32)
                       / loss_cfg.warmup_steps, 0.0, 1.0)
    return float(torch.pow(torch.tensor(loss_cfg.warmup_init_scale,
                                        dtype=torch.float32), 1.0 - frac))


@contextlib.contextmanager
def frozen(module: torch.nn.Module) -> Iterator[None]:
    """Parameters of ``module`` take no gradient inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def forward(state: TrainState, cfg: TrainConfig, bank: EffectBank,
            audio: torch.Tensor, msg: torch.Tensor, effect_idx,
            draws: Draws) -> Dict[str, torch.Tensor]:
    """Step 1: the composite forward with its graph. In a process group
    the localization's donors are the global batch's clean audio."""
    loss_cfg = cfg.loss
    donors = parallel.all_gather_rows(audio) if parallel.is_active() else None
    return forward_train(
        state.models, audio, msg, effect_idx, bank, draws, donors=donors,
        sample_rate=cfg.generator.sample_rate,
        window_duration=cfg.window_duration, remat=cfg.remat,
        clean_detector=loss_cfg.lambda_dec_clean > 0,
        jitter_hop=cfg.generator.hop_length if cfg.sub_hop_jitter else 0,
        lowband_cutoff=(loss_cfg.lowband_cutoff_hz
                        if loss_cfg.lambda_dec_lowband > 0 else 0.0))


def discriminator_update(state: TrainState, cfg: TrainConfig,
                         fake: torch.Tensor, audio: torch.Tensor,
                         alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2: (loss, pre-clip gradient norm of the gradient averaged over
    the ranks)."""
    models = state.models
    d_loss = discriminator_loss(models.apply_discriminator, fake.detach(),
                                audio, alpha=alpha,
                                gp_weight=cfg.loss.gp_weight)
    state.disc_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    parallel.all_reduce_grads(models.discriminator.parameters())
    norm = torch.nn.utils.clip_grad_norm_(models.discriminator.parameters(),
                                          MAX_GRADIENT_NORM)
    state.disc_opt.step()
    state.disc_sched.step()
    return d_loss.detach(), norm


def global_decoding_loss_bits(detector_logits: torch.Tensor,
                              presence_mask: Optional[torch.Tensor],
                              message: torch.Tensor,
                              bit_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``decoding_loss_bits`` of the rank's rows as a share of the global
    batch's: with a presence mask the count of valid samples is a global
    sum (detached) and the rank's sum is scaled by the number of ranks, so
    that the mean over the ranks of the loss and of its gradient is the
    global batch's, whatever count each rank holds. Without a mask, or
    without a process group, it is ``decoding_loss_bits`` itself."""
    if presence_mask is None or not parallel.is_active():
        return decoding_loss_bits(detector_logits, presence_mask, message,
                                  bit_mask=bit_mask)
    valid = (torch.sum(presence_mask, dim=1) > 0).to(detector_logits.dtype)
    return decoding_loss_bits(detector_logits, presence_mask, message,
                              bit_mask=bit_mask,
                              n_valid=parallel.global_sum(torch.sum(valid)),
                              scale=parallel.world_size())


def generator_losses(state: TrainState, cfg: TrainConfig,
                     outs: Dict[str, torch.Tensor], audio: torch.Tensor,
                     msg: torch.Tensor, percep_scale: float = 1.0,
                     adversarial: bool = True,
                     bit_mask: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Step 3's losses; ``"loss"`` is the weighted total. The
    discriminator's parameters take no gradient from them. ``percep_scale``
    weighs the stft, mel, waveform and adversarial terms; without
    ``adversarial`` those two terms are 0 and the discriminator does not
    run; ``bit_mask [nbits]`` weighs the bits of every decoding term."""
    lc = cfg.loss
    sr = cfg.generator.sample_rate
    w = outs["watermarked"]
    logs: Dict[str, torch.Tensor] = {}
    logs["stft/loss"] = multi_scale_stft_loss(
        w, audio, window_lengths=lc.stft_window_lengths)
    logs["mel/loss"] = mel_spectrogram_loss(
        w, audio, sample_rate=sr, n_mels=lc.mel_n_mels,
        window_lengths=lc.mel_window_lengths, clamp_eps=lc.mel_clamp_eps,
        mag_weight=lc.mel_mag_weight, pow=lc.mel_pow)
    logs["waveform/loss"] = l1_loss(w, audio)
    if adversarial:
        with frozen(state.models.discriminator):
            logs["adv/gen_loss"], logs["adv/feat_loss"] = generator_loss(
                state.models.apply_discriminator, w, audio)
    else:
        logs["adv/gen_loss"] = logs["adv/feat_loss"] = w.new_zeros(())
    bm = bit_mask  # every decoding term below takes it
    logs["dec/loss"] = decoding_loss(outs["detector_logits"], outs["mask"], msg,
                                     bit_mask=bm)
    logs["loc/loss"] = localization_loss(outs["locator_logits"], outs["mask"])
    total = (percep_scale * (lc.lambda_stft * logs["stft/loss"]
                             + lc.lambda_mel * logs["mel/loss"]
                             + lc.lambda_waveform * logs["waveform/loss"]
                             + lc.lambda_adv_gen * logs["adv/gen_loss"])
             + lc.lambda_dec * logs["dec/loss"]
             + lc.lambda_loc * logs["loc/loss"])
    ones = torch.ones_like(outs["mask"])
    if lc.lambda_dec_clean > 0:
        logs["dec/loss_clean"] = decoding_loss(outs["detector_logits_clean"],
                                               ones, msg, bit_mask=bm)
        total = total + lc.lambda_dec_clean * logs["dec/loss_clean"]
    if lc.lambda_dec_bits > 0:
        bits = global_decoding_loss_bits(outs["detector_logits"], outs["mask"],
                                         msg, bit_mask=bm)
        if lc.lambda_dec_clean > 0:
            bits = bits + decoding_loss_bits(outs["detector_logits_clean"],
                                             None, msg, bit_mask=bm)
        logs["dec/loss_bits"] = bits
        total = total + lc.lambda_dec_bits * bits
    if lc.lambda_dec_lowband > 0:
        lb = (decoding_loss(outs["detector_logits_lowband"], ones, msg,
                            bit_mask=bm)
              + decoding_loss_bits(outs["detector_logits_lowband"], None, msg,
                                   bit_mask=bm))
        logs["dec/loss_lowband"] = lb
        total = total + lc.lambda_dec_lowband * lb
    logs["loss"] = total
    return logs


def grad_norm(module: torch.nn.Module) -> torch.Tensor:
    """The global L2 norm of ``module``'s gradients."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in module.parameters()
         if p.grad is not None]))


def generator_update(state: TrainState, gen_update_scale: float = 1.0,
                     msg_update_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Step 4, on the gradients of step 3's backward: returns the three
    networks' gradient norms, the generator's before its clip. After
    the clip the generator's gradients are multiplied by
    ``gen_update_scale`` and its message path's
    (:func:`~waveverify_torch.train.state.in_msg_path`) by
    ``msg_update_scale``; AdamW then steps on them as optax does on the
    scaled tree: at 0 the moments decay and decoupled weight decay still
    applies."""
    models = state.models
    parallel.all_reduce_grads(p for net in ("generator", "detector", "locator")
                              for p in getattr(models, net).parameters())
    norms = {f"grad_norm/{net}": grad_norm(getattr(models, net))
             for net in ("detector", "locator")}
    norms["grad_norm/generator"] = torch.nn.utils.clip_grad_norm_(
        models.generator.parameters(), MAX_GRADIENT_NORM)
    with torch.no_grad():
        for name, p in models.generator.named_parameters():
            scale = gen_update_scale * (msg_update_scale if in_msg_path(name)
                                        else 1.0)
            if scale != 1.0:
                p.grad.mul_(scale)
    state.wm_opt.step()
    state.wm_sched.step()
    return norms


@torch.no_grad()
def feedback(outs: Dict[str, torch.Tensor], msg: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """Step 5: per-sample BER and MIoU (the rank's rows), their global
    means, and the per-bit decision accuracy of the mask-weighted time-mean
    logit over the global batch (global sums of the correct and the valid
    samples)."""
    logits, mask = outs["detector_logits"], outs["mask"]
    per_sample_ber = ber(logits, msg, mask, per_sample=True)
    per_sample_miou = miou(torch.sigmoid(outs["locator_logits"]), mask,
                           per_sample=True)
    pm = mask[:, :, None]
    denom = torch.sum(pm, dim=1)
    z = torch.sum(logits * pm, dim=1) / torch.clamp(denom, min=1.0)
    valid = (denom > 0).float()
    correct = ((z > 0) == (msg > 0.5)).float() * valid
    sums = parallel.global_sum(torch.cat([torch.sum(correct, dim=0),
                                          torch.sum(valid).reshape(1)]))
    per_bit_acc = sums[:-1] / torch.clamp(sums[-1], min=1.0)
    return parallel.global_means(
        {"train/ber": torch.mean(per_sample_ber),
         "train/miou": torch.mean(per_sample_miou),
         "per_sample_ber": per_sample_ber,
         "per_sample_miou": per_sample_miou,
         "per_bit_acc": per_bit_acc}, ("train/ber", "train/miou"))


def train_step(state: TrainState, cfg: TrainConfig, bank: EffectBank,
               audio: torch.Tensor, msg: torch.Tensor, effect_idx,
               draws: Draws, percep_scale: Optional[float] = None,
               train_disc: bool = True, gen_update_scale: float = 1.0,
               msg_update_scale: float = 1.0,
               bit_mask: Optional[torch.Tensor] = None,
               update_disc: bool = True) -> Dict[str, torch.Tensor]:
    """One step; updates ``state`` in place and returns its metrics as
    tensors on the device (the host reads them when it needs them).

    audio ``[B, T]``, msg ``[B, nbits]`` on the state's device;
    effect_idx ``[B]`` host indices into ``bank``; ``draws`` on the
    device; the controllers' inputs as the module docstring says
    (``bit_mask`` on the device). Without ``train_disc`` the discriminator,
    its optimizer and its schedule stay as they are, and
    ``adv/disc_loss`` and ``grad_norm/discriminator`` report 0. Without
    ``update_disc`` (the generator's half of the split step) the
    discriminator is not updated either, and those two report 0, but the
    adversarial terms still run against it when ``train_disc`` is on:
    :func:`disc_step` has updated it first."""
    with spans.span("train_step"):
        if percep_scale is None:
            percep_scale = step_ramp(state.step, cfg.loss)
        with spans.span("step.forward", device=True):
            outs = forward(state, cfg, bank, audio, msg, effect_idx, draws)
        if train_disc and update_disc:
            with spans.span("step.disc", device=True):
                d_loss, d_norm = discriminator_update(state, cfg, outs["residual"],
                                                      audio, draws.gp_alpha)
        else:
            d_loss = d_norm = audio.new_zeros(())
        with spans.span("step.gen_backward", device=True):
            logs = generator_losses(state, cfg, outs, audio, msg, percep_scale,
                                    adversarial=train_disc, bit_mask=bit_mask)
            state.wm_opt.zero_grad(set_to_none=False)
            logs["loss"].backward()
        with spans.span("step.update", device=True):
            norms = generator_update(state, gen_update_scale, msg_update_scale)
            state.step += 1
            losses = parallel.global_means(
                {**{k: v.detach() for k, v in logs.items()}, "adv/disc_loss": d_loss},
                list(logs) + ["adv/disc_loss"])
            return {**losses, **norms, "grad_norm/discriminator": d_norm,
                    **feedback(outs, msg)}


def disc_step(state: TrainState, cfg: TrainConfig, audio: torch.Tensor,
              msg: torch.Tensor, draws: Draws) -> Dict[str, torch.Tensor]:
    """The discriminator's half of the split step (JAX ``make_disc_step``):
    a no-grad generator forward, then the discriminator update on its
    output against the clean audio with the step's ``draws.gp_alpha``.
    ``state.step`` does not move; :func:`train_step` with
    ``update_disc=False`` follows, on the same inputs and draws."""
    with spans.span("disc_step"):
        with spans.span("step.forward", device=True), torch.no_grad():
            fake = state.models.apply_generator(audio, msg)
        with spans.span("step.disc", device=True):
            d_loss, d_norm = discriminator_update(state, cfg, fake, audio,
                                                  draws.gp_alpha)
            return {"adv/disc_loss": parallel.global_mean(d_loss),
                    "grad_norm/discriminator": d_norm}


def train_steps(state: TrainState, cfg: TrainConfig, bank: EffectBank,
                audios: torch.Tensor, msgs: torch.Tensor, idxs: Sequence,
                draws_list: Sequence[Draws], percep_scale: Optional[float] = None,
                train_disc: Optional[Sequence[bool]] = None,
                gen_update_scale: float = 1.0, msg_update_scale: float = 1.0,
                bit_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """K steps in one call (JAX ``make_multi_train_step``): audios
    ``[K, B, T]``, msgs ``[K, B, nbits]``, ``idxs`` K index arrays and
    ``draws_list`` K draws, one per step. ``percep_scale`` (None: each
    step's own step-indexed ramp), ``gen_update_scale``,
    ``msg_update_scale`` and ``bit_mask`` hold for the whole dispatch;
    ``train_disc`` is one flag per step (None: every step). Returns each
    metric stacked on a leading ``[K]`` axis, on the card: nothing inside
    waits for it."""
    k = len(draws_list)
    disc = [True] * k if train_disc is None else [bool(x) for x in train_disc]
    steps = [train_step(state, cfg, bank, audios[j], msgs[j], idxs[j],
                        draws_list[j], percep_scale, disc[j], gen_update_scale,
                        msg_update_scale, bit_mask) for j in range(k)]
    return {name: torch.stack([m[name] for m in steps]) for name in steps[0]}


@torch.no_grad()
def val_step(state: TrainState, cfg: TrainConfig, audio: torch.Tensor,
             msg: torch.Tensor, draws: Draws,
             eval_effects: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
    """Reconstruction losses and per-effect BER / MIoU over the sweep;
    ``val/loss`` is the total the trainer's ``best`` checkpoint tracks."""
    lc = cfg.loss
    sr = cfg.generator.sample_rate
    out = forward_valid(state.models, audio, msg, draws,
                        eval_effects=eval_effects, sample_rate=sr,
                        window_duration=cfg.window_duration)
    w = out["watermarked"]
    metrics: Dict[str, torch.Tensor] = {
        "val/stft_loss": multi_scale_stft_loss(
            w, audio, window_lengths=lc.stft_window_lengths),
        "val/mel_loss": mel_spectrogram_loss(
            w, audio, sample_rate=sr, n_mels=lc.mel_n_mels,
            window_lengths=lc.mel_window_lengths, clamp_eps=lc.mel_clamp_eps,
            mag_weight=lc.mel_mag_weight, pow=lc.mel_pow),
        "val/waveform_loss": l1_loss(w, audio),
        "val/sisnr": sisnr(w, audio),
    }
    for name, res in out["effects"].items():
        metrics[f"val/ber/{name}"] = res["ber"]
        metrics[f"val/miou/{name}"] = res["miou"]
    n = max(len(out["effects"]), 1)
    metrics["val/ber"] = sum(r["ber"] for r in out["effects"].values()) / n
    metrics["val/miou"] = sum(r["miou"] for r in out["effects"].values()) / n
    metrics["val/loss"] = (lc.lambda_stft * metrics["val/stft_loss"]
                           + lc.lambda_mel * metrics["val/mel_loss"]
                           + lc.lambda_waveform * metrics["val/waveform_loss"])
    return metrics
