"""The training loop: data, the effect scheduler's selection and feedback,
the training controllers, JSONL logging, validation, checkpoints and sample
dumps (counterpart of ``waveverify_tpu/train/loop.py``'s ``train``).

Per step the host makes the next batch, computes the controllers' inputs
for the step (:func:`step_inputs`), picks each sample's attack (integer
indices into the bank; the identity branch while the attack latch is
closed), draws the step's randomness and enqueues the step; the scheduler
and the controllers are fed the previous step's metrics while the card
runs the current one.

The controllers are host-side numpy code, copied from the JAX package with
their names: :class:`BerGatedRamp` (the BER-gated perceptual ramp, the
attack latch, the message-path freeze and its lockstep re-freeze) and
:class:`NbitsCurriculum`. Their states go into the checkpoint meta under
the JAX loop's keys (``ramp_state``, ``nbits_state``), so a meta written
by either package restores the other's controllers.

Across the ranks of a process group (``waveverify_torch.parallel``; the
CLI's ``--num-devices``), the loop is the JAX loop's over its data mesh:
each rank feeds ``batch_size / N`` rows from a data seed of its own and
selects its rows' attacks with its own scheduler, fed its own rows; every
step's draws are the global batch's, from one seed, each rank keeping its
rows; the controllers take the global ``train/ber`` and per-bit accuracy,
so they stay equal on every rank. Rank 0's state is broadcast after
set-up; only rank 0 logs, dumps samples, validates and checkpoints, and
every rank waits at a barrier before the first step and after each
validation block.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from waveverify_torch import parallel
from waveverify_torch.config import TrainConfig, model_config_dict
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.effects.effects_config import load_effects_config
from waveverify_torch.effects.scheduler import EffectScheduler
from waveverify_torch.serve import resolve_device, set_conv_precision
from waveverify_torch.train import checkpoint as ckpt
from waveverify_torch.train.data import (
    AudioFolderDataset,
    SyntheticAudioDataset,
    generate_random_message,
    prefetch_batches,
)
from waveverify_torch.train.state import TrainState, create_train_state, in_msg_path
from waveverify_torch.train.step import disc_step, train_step, train_steps, val_step
from waveverify_torch.train.watermarking import (
    draw,
    eval_random_effects,
    forward_audio_sample,
)

logger = logging.getLogger(__name__)

DEFAULT_CKPT_DIR = "runs/torch_train"


class Tracker:
    """Per-step time, a JSONL history and the best validation loss; every
    logged scalar is mirrored to TensorBoard under ``tb_dir`` and to a
    wandb project under ``wandb_project``, each where its package imports
    (the JAX package's Tracker). A sink that does not start is logged as a
    warning and the run goes on with the others."""

    def __init__(self, log_file: Optional[str] = None,
                 tb_dir: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 wandb_config: Optional[Dict] = None):
        self.best_val_loss = float("inf")
        self.log_file = Path(log_file) if log_file else None
        if self.log_file is not None:
            self.log_file.parent.mkdir(parents=True, exist_ok=True)
        self._t_last = time.perf_counter()
        self._last_step: Optional[int] = None
        self._tb = None
        self._wandb = None
        if tb_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tb_dir)
            except Exception as exc:  # an optional sink never stops a run
                logger.warning("TensorBoard unavailable (%s); JSONL only", exc)
        if wandb_project is not None:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project,
                                         config=wandb_config or {})
            except Exception as exc:
                logger.warning("wandb unavailable (%s); JSONL/TB only", exc)

    def update(self, step: int, metrics: Dict[str, float],
               include_time: bool = True) -> Dict[str, float]:
        """Log scalar ``metrics`` at ``step``; with ``include_time`` add
        ``step_time``, the seconds per step since the last such update."""
        now = time.perf_counter()
        if include_time:
            d_steps = (max(1, step - self._last_step)
                       if self._last_step is not None else 1)
            metrics = dict(metrics, step_time=(now - self._t_last) / d_steps)
            self._last_step = step
        self._t_last = now
        if self.log_file:
            with self.log_file.open("a") as f:
                f.write(json.dumps({"step": step, **metrics}) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        return metrics

    def log_audio(self, step: int, name: str, audio: np.ndarray,
                  sample_rate: int) -> None:
        """Mirror an audio sample to the live sinks; a failure is logged
        and the run goes on."""
        if self._wandb is not None:
            try:
                import wandb

                self._wandb.log({name: wandb.Audio(audio, sample_rate=sample_rate)},
                                step=step)
            except Exception:
                logger.exception("wandb audio log failed; continuing")
        if self._tb is not None:
            try:
                self._tb.add_audio(name, torch.from_numpy(audio).reshape(1, -1),
                                   step, sample_rate=sample_rate)
            except Exception:
                logger.exception("TB audio log failed; continuing")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()

    def is_best(self, val_loss: float) -> bool:
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            return True
        return False


class BerGatedRamp:
    """Host-side controller of the BER-gated perceptual ramp (copy of the
    JAX package's, ``LossConfig.warmup_ber_gate``).

    Ramp *progress* (0..1, never backward) advances by 1/steps per step
    only while the train-BER EMA is at or below ``gate``; the perceptual
    weight is ``init_scale ** (1 - progress)``. Three latches ride on the
    same EMA: the attack latch (effects identity-only until the EMA first
    reaches ``fx_gate``, perceptual weight exactly 0 until then; the EMA
    restarts at chance when it opens), the message-path freeze (generator
    ``msg_*`` / ``film_*`` updates zeroed until the EMA first reaches
    ``msg_freeze_gate``) and, with ``msg_refreeze``, the lockstep
    re-freeze: the message path freezes again while any active bit's
    accuracy EMA sits below 0.35 and thaws once all are above 0.45.
    EMAs are float64, as in the JAX package.
    """

    def __init__(self, steps: int, init_scale: float, gate: float,
                 beta: float = 0.98, fx_gate: float = 0.0,
                 msg_freeze_gate: float = 0.0, msg_refreeze: bool = False,
                 nbits: int = 16):
        self.steps = max(int(steps), 1)
        self.init_scale = float(init_scale)
        self.gate = float(gate)
        self.beta = float(beta)
        self.progress = 0.0
        self.ema = 0.5  # chance-level prior
        self.fx_gate = float(fx_gate)
        self.fx_latched = fx_gate <= 0.0
        self.msg_freeze_gate = float(msg_freeze_gate)
        self.msg_latched = msg_freeze_gate <= 0.0
        self.msg_refreeze = bool(msg_refreeze)
        self.msg_refreeze_lo = 0.35
        self.msg_refreeze_hi = 0.45
        self.msg_refrozen = False
        self.bit_acc_ema = np.full(int(nbits), 0.5, np.float64)

    def scale(self) -> float:
        """The perceptual weight: exactly 0 until the attack latch opens."""
        if not self.fx_latched:
            return 0.0
        return float(self.init_scale ** (1.0 - self.progress))

    def attacks_on(self) -> bool:
        return self.fx_latched

    def msg_on(self) -> bool:
        """Whether the message path may update: the freeze latch has
        opened and no lockstep re-freeze is active."""
        return self.msg_latched and not self.msg_refrozen

    def update(self, ber: float, k: int = 1,
               per_bit_acc: Optional[np.ndarray] = None,
               n_active: Optional[int] = None) -> None:
        """Feed one step's attacked-path BER (the active bits' when the
        curriculum is on) covering ``k`` steps; ``per_bit_acc [nbits]``
        drives the lockstep re-freeze."""
        self.ema = self.beta * self.ema + (1.0 - self.beta) * float(ber)
        if not self.fx_latched and self.ema <= self.fx_gate:
            self.fx_latched = True
            logger.info("attack curriculum: BER EMA %.4f <= fx_gate %.3f: "
                        "effects latched on", self.ema, self.fx_gate)
            # the EMA measured the unattacked code until now
            self.ema = 0.5
        if not self.msg_latched and self.ema <= self.msg_freeze_gate:
            self.msg_latched = True
            logger.info("carrier freeze: BER EMA %.4f <= msg_freeze_gate %.3f: "
                        "message path unfrozen", self.ema, self.msg_freeze_gate)
        if per_bit_acc is not None and self.msg_refreeze:
            acc = np.asarray(per_bit_acc, np.float64)
            self.bit_acc_ema[: len(acc)] = (
                self.beta * self.bit_acc_ema[: len(acc)]
                + (1.0 - self.beta) * acc)
            n = (len(self.bit_acc_ema) if n_active is None
                 else max(1, int(n_active)))
            lo = float(self.bit_acc_ema[:n].min())
            if (self.msg_latched and not self.msg_refrozen
                    and lo < self.msg_refreeze_lo):
                self.msg_refrozen = True
                logger.info("lockstep: active-bit accuracy EMA min %.3f < %.2f: "
                            "message path re-frozen", lo, self.msg_refreeze_lo)
            elif self.msg_refrozen and lo > self.msg_refreeze_hi:
                self.msg_refrozen = False
                logger.info("lockstep cleared: active-bit accuracy EMA min "
                            "%.3f > %.2f: message path thawed", lo,
                            self.msg_refreeze_hi)
        # the squeeze never advances on the clean-path BER
        if self.fx_latched and self.ema <= self.gate:
            self.progress = min(1.0, self.progress + k / self.steps)

    def state_dict(self) -> Dict[str, Any]:
        return {"progress": self.progress, "ema": self.ema,
                "fx_latched": float(self.fx_latched),
                "msg_latched": float(self.msg_latched),
                "msg_refrozen": float(self.msg_refrozen),
                "bit_acc_ema": self.bit_acc_ema.tolist()}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.progress = float(d.get("progress", 0.0))
        self.ema = float(d.get("ema", 0.5))
        self.fx_latched = bool(d.get("fx_latched",
                                     1.0 if self.fx_gate <= 0 else 0.0))
        self.msg_latched = bool(d.get(
            "msg_latched", 1.0 if self.msg_freeze_gate <= 0 else 0.0))
        self.msg_refrozen = bool(d.get("msg_refrozen", 0.0))
        ema = d.get("bit_acc_ema")
        if ema is not None and len(ema) == len(self.bit_acc_ema):
            self.bit_acc_ema = np.asarray(ema, np.float64)


class NbitsCurriculum:
    """Host-side nbits curriculum (copy of the JAX package's,
    ``LossConfig.warmup_nbits_start``): the first ``start`` bits are
    active; whenever the active bits' accuracy EMA reaches ``1 - gate`` the
    active count doubles (up to nbits) and the new bits' EMA restarts at
    chance. :meth:`mask` is the step's ``[nbits]`` 0/1 bit weights."""

    def __init__(self, nbits: int, start: int, gate: float,
                 beta: float = 0.98):
        self.nbits = int(nbits)
        self.n_active = max(1, min(int(start), self.nbits))
        self.gate = float(gate)
        self.beta = float(beta)
        self.acc_ema = np.full(self.nbits, 0.5, np.float64)

    def mask(self) -> np.ndarray:
        return (np.arange(self.nbits) < self.n_active).astype(np.float32)

    def update(self, per_bit_acc: np.ndarray) -> None:
        self.acc_ema = (self.beta * self.acc_ema
                        + (1.0 - self.beta) * np.asarray(per_bit_acc,
                                                         np.float64))
        if self.n_active < self.nbits:
            active_ber = 1.0 - float(self.acc_ema[: self.n_active].mean())
            if active_ber <= self.gate:
                old = self.n_active
                self.n_active = min(2 * self.n_active, self.nbits)
                self.acc_ema[old: self.n_active] = 0.5
                logger.info("nbits curriculum: active-bit BER %.4f <= gate "
                            "%.3f: %d -> %d active bits", active_ber,
                            self.gate, old, self.n_active)

    def state_dict(self) -> Dict[str, Any]:
        return {"n_active": self.n_active, "acc_ema": self.acc_ema.tolist()}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.n_active = int(d.get("n_active", self.n_active))
        ema = d.get("acc_ema")
        if ema is not None and len(ema) == self.nbits:
            self.acc_ema = np.asarray(ema, np.float64)


def make_controllers(cfg: TrainConfig
                     ) -> Tuple[Optional[BerGatedRamp], Optional[NbitsCurriculum]]:
    """(ramp, curriculum) of a run, as the JAX loop makes them: the ramp
    only with ``warmup_ber_gate > 0``, the curriculum only with the ramp
    and ``warmup_nbits_start > 0``."""
    lc = cfg.loss
    if lc.warmup_ber_gate <= 0:
        return None, None
    ramp = BerGatedRamp(lc.warmup_steps, lc.warmup_init_scale,
                        lc.warmup_ber_gate, fx_gate=lc.warmup_fx_gate,
                        msg_freeze_gate=lc.warmup_msg_freeze_gate,
                        msg_refreeze=lc.warmup_msg_refreeze,
                        nbits=cfg.generator.msg_dimension)
    curr = None
    if lc.warmup_nbits_start > 0:
        curr = NbitsCurriculum(cfg.generator.msg_dimension,
                               lc.warmup_nbits_start, lc.warmup_nbits_gate)
    return ramp, curr


@dataclass(frozen=True)
class StepInputs:
    """The controllers' inputs to one train step (see ``train/step.py``),
    and whether the step's attacks come from the scheduler (``fx_on``)."""

    percep_scale: Optional[float]
    train_disc: bool
    gen_update_scale: float
    msg_update_scale: float
    bit_mask: Optional[np.ndarray]
    fx_on: bool


def step_inputs(step: int, ramp: Optional[BerGatedRamp],
                curr: Optional[NbitsCurriculum], loss_cfg) -> StepInputs:
    """The inputs of step ``step``, as the JAX loop computes them:

    - ``percep_scale``: ``ramp.scale()``; None without the ramp, so that
      ``train_step`` takes its step-indexed ramp;
    - ``train_disc``: every step once the ramp has progress, else every
      ``warmup_disc_every``-th;
    - ``gen_update_scale``: with ``warmup_alt_period`` and no progress
      yet, 1 only in the last ``max(1, int(period * alt_gen_frac))`` steps
      of each period, else 0 (the detector re-aligns to a still generator
      first); otherwise 1;
    - ``msg_update_scale``: ``ramp.msg_on()``; ``bit_mask``:
      ``curr.mask()``; ``fx_on``: ``ramp.attacks_on()``.

    Without the ramp the alternation and cadence knobs are ignored."""
    if ramp is None:
        return StepInputs(None, True, 1.0, 1.0, None, True)
    squeezing = ramp.progress > 0.0
    gen_on = True
    if loss_cfg.warmup_alt_period > 0:
        period = loss_cfg.warmup_alt_period
        gen_steps = max(1, int(period * loss_cfg.warmup_alt_gen_frac))
        gen_on = squeezing or step % period >= period - gen_steps
    return StepInputs(
        percep_scale=ramp.scale(),
        train_disc=bool(squeezing or step % loss_cfg.warmup_disc_every == 0),
        gen_update_scale=1.0 if gen_on else 0.0,
        msg_update_scale=1.0 if ramp.msg_on() else 0.0,
        bit_mask=curr.mask() if curr is not None else None,
        fx_on=ramp.attacks_on())


def dispatch_inputs(step: int, k: int, ramp: Optional[BerGatedRamp],
                    curr: Optional[NbitsCurriculum], loss_cfg
                    ) -> Tuple[StepInputs, List[bool]]:
    """The inputs of the dispatch of steps [step, step + k), as the JAX loop
    makes them: the controllers' inputs of its first step, held for all k
    steps, and the discriminator's cadence, one flag per step (the
    controllers do not move inside a dispatch)."""
    return (step_inputs(step, ramp, curr, loss_cfg),
            [step_inputs(step + j, ramp, curr, loss_cfg).train_disc
             for j in range(k)])


def feed_controllers(ramp: Optional[BerGatedRamp],
                     curr: Optional[NbitsCurriculum], train_ber,
                     per_bit_acc, k: int = 1) -> None:
    """One dispatch's feedback, covering ``k`` steps, as the JAX loop feeds
    it: the curriculum takes the per-bit accuracy (its mean over the
    dispatch's steps when it is ``[k, nbits]``); the ramp takes the active
    bits' BER when the curriculum is on, else the mean of ``train/ber``,
    and advances by ``k`` steps."""
    acc = np.asarray(per_bit_acc)
    acc = acc.mean(axis=0) if acc.ndim == 2 else acc
    if curr is not None:
        curr.update(acc)
        gate_ber = 1.0 - float(acc[: curr.n_active].mean())
    else:
        gate_ber = float(np.mean(np.asarray(train_ber)))
    if ramp is not None:
        ramp.update(gate_ber, k=k, per_bit_acc=acc,
                    n_active=curr.n_active if curr is not None else None)


def _identity_branch(bank: EffectBank) -> int:
    """Index of the identity branch in the effect bank."""
    for i, (name, _) in enumerate(bank.specs):
        if name == "identity":
            return i
    return 0


@dataclass(frozen=True)
class TrainerConfig:
    """Host-side options of a run.

    ``log_file`` None logs to ``<ckpt_dir>/train_log.jsonl``;
    ``init_weights`` warm-starts the three networks from a weights ``.npz``
    when no checkpoint is resumed (the discriminator, optimizers and their
    lr schedules start fresh); ``init_meta``, a checkpoint's ``meta.json``
    (the JAX trainer's or this one's), applied with ``init_weights``,
    restores the step count and the effect scheduler's, ramp's and nbits
    curriculum's states; ``reinit_msg_path`` replaces the ``msg_*`` /
    ``film_*`` parameters of the three networks with fresh ones after the
    warm start (skipped when a checkpoint was resumed); ``conv_precision``
    "highest" (or None) runs f32 with TF32 off on the card, "high" or
    "default" allow TF32 in cuDNN and cuBLAS.

    The JAX loop's other options: ``steps_per_dispatch`` K steps per call
    (:func:`~waveverify_torch.train.step.train_steps`; the controllers
    and the scheduler are fed once per dispatch, and the run ends at the
    first multiple of K past its length); ``split_disc_step`` the split
    step (K = 1 only); ``effect_dispatch`` the bank's ``"stack"`` or
    ``"scan"``; ``match_reference_effect_cap`` the reference scheduler's
    cap on attacked samples; ``profile_start`` / ``profile_stop`` a
    ``torch.profiler`` trace of those steps in ``<ckpt_dir>/profile``;
    ``tensorboard_dir`` and ``wandb_project`` the Tracker's mirrors;
    ``debug_nans`` autograd's anomaly mode and a finiteness check of each
    step's losses and gradient norms, raising ``FloatingPointError``;
    ``num_devices`` the data mesh's size, which must be the number of ranks
    in the process group (None: whatever joined; see
    :mod:`waveverify_torch.parallel`).
    """

    train_folders: Tuple[str, ...] = ()
    val_folders: Tuple[str, ...] = ()
    ckpt_dir: str = DEFAULT_CKPT_DIR
    log_file: Optional[str] = None
    init_weights: Optional[str] = None
    init_meta: Optional[str] = None
    reinit_msg_path: bool = False
    save_iters: Tuple[int, ...] = (100000, 200000, 400000, 600000)
    log_every: int = 50
    dump_samples: bool = True
    effects_config: Optional[str] = None
    conv_precision: Optional[str] = None
    device: str = "cuda"
    steps_per_dispatch: int = 1
    split_disc_step: bool = False
    effect_dispatch: str = "stack"
    match_reference_effect_cap: bool = False
    profile_start: Optional[int] = None
    profile_stop: Optional[int] = None
    tensorboard_dir: Optional[str] = None
    wandb_project: Optional[str] = None
    debug_nans: bool = False
    num_devices: Optional[int] = None


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws: a function of (seed, step)
    alone, so a resumed run draws what an unbroken one would."""
    return torch.Generator().manual_seed((seed << 32) + step)


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Start copying a step's metrics to the host without waiting."""
    return {k: v.detach().to("cpu", non_blocking=True) for k, v in metrics.items()}


def _feed_scheduler(scheduler: EffectScheduler, metrics: Dict[str, Any],
                    selections: List) -> None:
    """One scheduler update per sample from its BER and MIoU; with K steps
    per dispatch, ``selections`` holds K lists and the metrics are
    ``[K, B]``."""
    bers = np.asarray(metrics["per_sample_ber"])
    mious = np.asarray(metrics["per_sample_miou"])
    if selections and isinstance(selections[0], list):
        for k, sel in enumerate(selections):
            _feed_scheduler(scheduler, {"per_sample_ber": bers[k],
                                        "per_sample_miou": mious[k]}, sel)
        return
    for i, (name, params) in enumerate(selections[:len(bers)]):
        scheduler.update_effect_metrics(name, params,
                                        float(np.clip(bers[i], 0.0, 1.0)),
                                        float(np.clip(mious[i], 0.0, 1.0)))


def _dump_audio_samples(state: TrainState, audio: torch.Tensor,
                        msg: torch.Tensor, ckpt_dir: str, step: int,
                        sample_rate: int, n: int = 2,
                        tracker: Optional[Tracker] = None) -> None:
    """Write n (clean, watermarked) WAV pairs under
    ``<ckpt_dir>/samples/step_<step>``, each watermarked one mirrored to
    the tracker's live sinks."""
    from waveverify_torch.api.audio_io import save_audio

    out_dir = Path(ckpt_dir) / "samples" / f"step_{step}"
    out_dir.mkdir(parents=True, exist_ok=True)
    _, watermarked = forward_audio_sample(state.models, audio[:n], msg[:n])
    clean, watermarked = audio[:n].cpu().numpy(), watermarked.cpu().numpy()
    for i in range(len(clean)):
        save_audio(clean[i], out_dir / f"{i}_clean.wav", sample_rate)
        save_audio(watermarked[i], out_dir / f"{i}_watermarked.wav", sample_rate)
        if tracker is not None:
            tracker.log_audio(step, f"samples/{i}_watermarked", watermarked[i],
                              sample_rate)


def _validate_and_save(state: TrainState, cfg: TrainConfig,
                       trainer: TrainerConfig, tracker: Tracker,
                       scheduler: EffectScheduler, val_ds, val_rng,
                       eval_effects, step: int, step_end: int,
                       ramp: Optional[BerGatedRamp] = None,
                       curr: Optional[NbitsCurriculum] = None) -> None:
    """After the dispatch of steps [step, step_end): validation, then the
    ``latest``, ``best`` and ``save_iters`` checkpoints. Neither stops a
    long run: a failure is logged with its traceback and training goes
    on."""
    device = next(state.models.parameters()).device
    vmetrics: Dict[str, float] = {}
    try:
        vaudio = torch.from_numpy(val_ds.batch(cfg.val_batch_size)).to(device)
        vmsg = torch.from_numpy(generate_random_message(
            val_rng, cfg.val_batch_size, cfg.generator.msg_dimension)).to(device)
        vdraws = draw(step_generator(cfg.seed, 1_000_000 + step),
                      cfg.val_batch_size, vaudio.shape[1],
                      eval_random_effects(eval_effects),
                      cfg.generator.sample_rate, cfg.window_duration,
                      gp=False).to(device)
        vmetrics = {k: float(v) for k, v in val_step(
            state, cfg, vaudio, vmsg, vdraws, eval_effects).items()}
        tracker.update(step_end - 1, vmetrics, include_time=False)
        logger.info("val @%d: loss %.4f ber %.4f miou %.4f", step_end,
                    vmetrics["val/loss"], vmetrics["val/ber"], vmetrics["val/miou"])
    except Exception:
        logger.exception("validation failed at step %d; continuing", step_end)
    # the JAX loop's keys, so either package's meta restores the other's
    host_state = {"step": step_end,
                  "nbits_state": curr.state_dict() if curr is not None else None,
                  "scheduler_state": scheduler.state_dict(),
                  "best_val_loss": tracker.best_val_loss,
                  "model_config": model_config_dict(cfg)}
    if ramp is not None:
        host_state["ramp_state"] = ramp.state_dict()
    try:
        ckpt.save_checkpoint(trainer.ckpt_dir, "latest", state, cfg, host_state)
        if vmetrics and tracker.is_best(vmetrics["val/loss"]):
            host_state["best_val_loss"] = tracker.best_val_loss
            ckpt.save_checkpoint(trainer.ckpt_dir, "best", state, cfg, host_state)
        hit = [t for t in trainer.save_iters if step < t <= step_end]
        if hit:
            ckpt.save_checkpoint(trainer.ckpt_dir, f"{hit[-1] // 1000}k", state,
                                 cfg, host_state)
    except Exception:
        logger.exception("checkpoint save failed at step %d; continuing", step_end)


def _restore_controllers(meta: Dict[str, Any], scheduler: EffectScheduler,
                         ramp: Optional[BerGatedRamp],
                         curr: Optional[NbitsCurriculum]) -> None:
    """The host state of a checkpoint meta: scheduler, ramp, curriculum."""
    if meta.get("scheduler_state"):
        scheduler.load_state_dict(meta["scheduler_state"])
    if ramp is not None and meta.get("ramp_state"):
        ramp.load_state_dict(meta["ramp_state"])
    if curr is not None and meta.get("nbits_state"):
        curr.load_state_dict(meta["nbits_state"])


def _msg_path_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """Copies of the three networks' message-path parameters, by dotted
    name (``net.path``)."""
    return {f"{net}.{n}": p.detach().clone()
            for net in ("generator", "detector", "locator")
            for n, p in getattr(state.models, net).named_parameters()
            if in_msg_path(n)}


def _replicate(state: TrainState) -> None:
    """Rank 0's parameters, buffers, optimizer moments, schedules and step
    count on every rank of the process group, whatever each rank read at
    set-up (no-op without a group)."""
    if not parallel.is_active():
        return
    opts = (state.wm_opt, state.disc_opt)
    tensors = list(state.models.state_dict(keep_vars=True).values())
    host = []  # optimizer state kept off the card (AdamW's step counts)
    for opt in opts:
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                for k in sorted(st):
                    (tensors if st[k].device == p.device else host).append(st[k])
    parallel.broadcast_tensors(tensors)
    src = parallel.broadcast_object({
        "step": state.step, "wm_sched": state.wm_sched.state_dict(),
        "disc_sched": state.disc_sched.state_dict(),
        "lrs": [[g["lr"] for g in opt.param_groups] for opt in opts],
        "host": [t.tolist() for t in host]})
    if len(src["host"]) != len(host):
        raise RuntimeError(f"rank {parallel.rank()} holds {len(host)} host-side "
                           f"optimizer tensors, rank 0 {len(src['host'])}")
    with torch.no_grad():
        for t, v in zip(host, src["host"]):
            t.copy_(torch.tensor(v, dtype=t.dtype))
    state.step = src["step"]
    state.wm_sched.load_state_dict(src["wm_sched"])
    state.disc_sched.load_state_dict(src["disc_sched"])
    for opt, lrs in zip(opts, src["lrs"]):
        for group, lr in zip(opt.param_groups, lrs):
            group["lr"] = lr


def check_finite(metrics: Dict[str, torch.Tensor], step: int) -> None:
    """Raise ``FloatingPointError`` naming the step and the first loss or
    gradient norm of a step's metrics (stacked ``[K]`` for a dispatch that
    starts at ``step``) that is not finite. One wait for the card."""
    names = [k for k in metrics if "loss" in k or k.startswith("grad_norm/")]
    finite = torch.stack([torch.isfinite(metrics[k]).reshape(-1)
                          for k in names]).cpu()
    if bool(finite.all()):
        return
    j = int(torch.nonzero(~finite.all(dim=0))[0])
    name = names[int(torch.nonzero(~finite[:, j])[0])]
    value = float(metrics[name].reshape(-1)[j])
    raise FloatingPointError(f"step {step + j}: {name} is {value}")


class _StepProfile:
    """A ``torch.profiler`` trace of steps [start, stop), checked at each
    dispatch's first step as the JAX loop checks it, written as a Chrome
    trace to ``<ckpt_dir>/profile/steps_<first>_<end>.json`` when it stops
    (at ``stop`` or at the end of the run); each rank of a process group
    traces itself, into ``..._rank<r>.json``."""

    def __init__(self, ckpt_dir: str, start: Optional[int],
                 stop: Optional[int], device: torch.device):
        self.dir = Path(ckpt_dir) / "profile"
        self.start, self.stop = start, stop
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = None
        self._first = None

    def at(self, step: int) -> None:
        if (self.start is not None and self._prof is None
                and self._first is None and step >= self.start
                and (self.stop is None or step < self.stop)):
            self._prof = torch.profiler.profile(activities=self.activities)
            self._prof.start()
            self._first = step
        if self._prof is not None and self.stop is not None and step >= self.stop:
            self.finish(step)

    def finish(self, step: int) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        tag = f"_rank{parallel.rank()}" if parallel.world_size() > 1 else ""
        path = self.dir / f"steps_{self._first}_{step}{tag}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        logger.info("profile of steps [%d, %d) written to %s", self._first, step, path)


def train(cfg: TrainConfig, trainer: TrainerConfig = TrainerConfig(),
          max_steps: Optional[int] = None, resume: bool = False) -> TrainState:
    """A training run; returns the final state. Runs on ``trainer.device``
    (``cuda`` by default; raises without a card). ``max_steps`` is the
    step count to stop at, counted from 0 (a resumed or restored run starts
    at its checkpoint's step); with K steps per dispatch the run goes on to
    the end of the dispatch that reaches it, as the JAX loop does. In a
    process group every rank calls it, on its own device (the module
    docstring says what each rank does)."""
    k_steps = max(1, int(trainer.steps_per_dispatch))
    if trainer.split_disc_step and k_steps > 1:
        raise ValueError("split_disc_step requires steps_per_dispatch=1")
    resolve_device(trainer.device)
    mesh = parallel.make_mesh(trainer.num_devices, trainer.device)
    lo, hi = mesh.rows(cfg.batch_size)
    local_bs = hi - lo
    is_main = mesh.index == 0
    device = mesh.device
    if device.type == "cuda":
        set_conv_precision(trainer.conv_precision or "highest")
    sr = cfg.generator.sample_rate
    lc = cfg.loss
    fx_cfg = load_effects_config(trainer.effects_config)
    bank = EffectBank(fx_cfg.train_effects, sr, dispatch=trainer.effect_dispatch)
    eval_effects = list(fx_cfg.eval_effects)
    scheduler = EffectScheduler(
        effect_params=fx_cfg.effect_param_grid, beta=fx_cfg.beta,
        ber_threshold=fx_cfg.ber_threshold,
        miou_threshold=fx_cfg.miou_threshold,
        rng=np.random.RandomState(cfg.seed + 1))
    log_file = trainer.log_file or str(Path(trainer.ckpt_dir) / "train_log.jsonl")
    # the log and its mirrors are rank 0's
    tracker = Tracker(log_file if is_main else None,
                      tb_dir=trainer.tensorboard_dir if is_main else None,
                      wandb_project=trainer.wandb_project if is_main else None,
                      wandb_config={"batch_size": cfg.batch_size,
                                    "num_iters": cfg.num_iters,
                                    "lr": cfg.optim.lr})
    ramp, curr = make_controllers(cfg)
    # which of the controllers' keys the log carries (the JAX loop's rule)
    alt = ramp is not None and lc.warmup_alt_period > 0
    msg_freeze = ((ramp is not None and (lc.warmup_msg_freeze_gate > 0
                                         or lc.warmup_msg_refreeze))
                  or curr is not None)

    state = create_train_state(cfg, torch.Generator().manual_seed(cfg.seed),
                               device)
    fresh_msg = _msg_path_params(state) if trainer.reinit_msg_path else None
    resumed = resume and "latest" in ckpt.checkpoint_tags(trainer.ckpt_dir)
    if resumed:
        parallel.barrier()
        meta = ckpt.load_checkpoint(trainer.ckpt_dir, "latest", state, cfg)
        _restore_controllers(meta, scheduler, ramp, curr)
        tracker.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        logger.info("resumed from step %d", state.step)
    elif trainer.init_weights:
        ckpt.load_weights(state.models, trainer.init_weights)
        logger.info("warm-started from %s", trainer.init_weights)
        if trainer.init_meta:
            meta = json.loads(Path(trainer.init_meta).read_text())
            state.step = int(meta.get("step", 0))
            _restore_controllers(meta, scheduler, ramp, curr)
            logger.info("restored controller state from %s (step %d, ramp %s, "
                        "nbits %s)", trainer.init_meta, state.step,
                        ramp.state_dict() if ramp is not None else None,
                        curr.n_active if curr is not None else None)
    # a relaunch that resumed from a checkpoint keeps the message path it
    # learned since the graft
    if fresh_msg is not None and resumed:
        logger.info("resumed from a checkpoint: message path not re-initialized")
    elif fresh_msg is not None:
        with torch.no_grad():
            for net in ("generator", "detector", "locator"):
                for n, p in getattr(state.models, net).named_parameters():
                    if f"{net}.{n}" in fresh_msg:
                        p.copy_(fresh_msg[f"{net}.{n}"])
        logger.info("re-initialized the message path (msg_*, film_*)")
    _replicate(state)
    start_step = state.step

    # on resume the data stream continues with fresh clips; each rank has
    # a stream of its own
    data_seed = cfg.seed + start_step + 7919 * mesh.index
    if trainer.train_folders:
        train_ds = AudioFolderDataset(trainer.train_folders, cfg.train_duration,
                                      sr, data_seed)
    else:
        logger.warning("no train folders given: using synthetic audio")
        train_ds = SyntheticAudioDataset(cfg.train_duration, sr, data_seed)
    if trainer.val_folders:
        val_ds = AudioFolderDataset(trainer.val_folders, cfg.val_duration, sr,
                                    cfg.seed + 7)
    else:
        val_ds = SyntheticAudioDataset(cfg.val_duration, sr, cfg.seed + 7)
    val_rng = np.random.RandomState(cfg.seed + 13)
    nbits = cfg.generator.msg_dimension
    jitter_hop = cfg.generator.hop_length if cfg.sub_hop_jitter else 0
    total = max_steps if max_steps is not None else cfg.num_iters
    identity = _identity_branch(bank)

    batches = prefetch_batches(train_ds, local_bs, nbits, data_seed)

    def host_inputs(step: int, fx_on: bool):
        """Step ``step``'s rows of this rank, their attacks (the identity
        branch while the attack latch is closed) and their draws, on the
        host: the global batch's draws, cut to this rank's rows."""
        audio_np, msg_np = next(batches)
        if fx_on:
            idx, selections = scheduler.select_bank_indices(
                local_bs, bank.specs,
                match_reference_cap=trainer.match_reference_effect_cap)
        else:
            idx = np.full(local_bs, identity, np.int32)
            selections = [bank.specs[identity]] * local_bs
        # per-sample draws follow every rank's attacks, in the global order
        global_idx = (np.concatenate(parallel.all_gather_object(idx))
                      if bank.dispatch == "scan" and mesh.size > 1 else idx)
        draws = draw(step_generator(cfg.seed, step), cfg.batch_size,
                     audio_np.shape[1], bank.draw_specs(global_idx), sr,
                     cfg.window_duration, jitter_hop,
                     per_sample=bank.dispatch == "scan")
        if mesh.size > 1:
            draws = draws.rows(lo, hi)
        return audio_np, msg_np, idx, selections, draws

    def run_dispatch(inputs, train_disc, parts, audios, msgs, draws, held):
        """The dispatch's steps: one step (the split step's two halves with
        ``split_disc_step``, its discriminator's only where it trains) or
        K steps; returns (metrics, the scheduler's selections)."""
        if k_steps > 1:
            return (train_steps(state, cfg, bank, audios, msgs,
                                [p[2] for p in parts], draws,
                                train_disc=train_disc, **held),
                    [p[3] for p in parts])
        disc_metrics = {}
        if trainer.split_disc_step and inputs.train_disc:
            disc_metrics = disc_step(state, cfg, audios[0], msgs[0], draws[0])
        metrics = train_step(state, cfg, bank, audios[0], msgs[0], parts[0][2],
                             draws[0], train_disc=inputs.train_disc,
                             update_disc=not trainer.split_disc_step, **held)
        return {**metrics, **disc_metrics}, parts[0][3]

    pending = None  # (host metrics, selections, event) of the last dispatch
    host_s, host_steps = 0.0, 0  # host time on data and the scheduler
    profile = _StepProfile(trainer.ckpt_dir, trainer.profile_start,
                           trainer.profile_stop, device)
    step = start_step
    # every rank has built its state and its data before the first collective
    parallel.barrier()
    try:
        with torch.autograd.set_detect_anomaly(trainer.debug_nans):
            while step < total:
                profile.at(step)
                t_host = time.perf_counter()
                inputs, train_disc = dispatch_inputs(step, k_steps, ramp, curr, lc)
                bit_mask = (None if inputs.bit_mask is None
                            else torch.from_numpy(inputs.bit_mask).to(device))
                held = dict(percep_scale=inputs.percep_scale,
                            gen_update_scale=inputs.gen_update_scale,
                            msg_update_scale=inputs.msg_update_scale,
                            bit_mask=bit_mask)
                parts = [host_inputs(step + j, inputs.fx_on) for j in range(k_steps)]
                audios = torch.from_numpy(np.stack([p[0] for p in parts])).to(device)
                msgs = torch.from_numpy(np.stack([p[1] for p in parts])).to(device)
                draws = [p[4].to(device) for p in parts]
                host_s += time.perf_counter() - t_host
                try:
                    metrics, selections = run_dispatch(inputs, train_disc, parts,
                                                       audios, msgs, draws, held)
                except RuntimeError as e:
                    # autograd's anomaly mode found a NaN in a backward
                    if trainer.debug_nans and "nan values" in str(e):
                        raise FloatingPointError(f"step {state.step}: {e}") from e
                    raise
                if trainer.debug_nans:
                    check_finite(metrics, step)

                # the scheduler and the controllers take the last dispatch's
                # metrics while the card runs this one
                t_host = time.perf_counter()
                if pending is not None:
                    if pending[2] is not None:
                        pending[2].synchronize()
                    _feed_scheduler(scheduler, pending[0], pending[1])
                    feed_controllers(ramp, curr, pending[0]["train/ber"].numpy(),
                                     pending[0]["per_bit_acc"].numpy(), k=k_steps)
                host_metrics = _to_host(metrics)
                event = None
                if device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                pending = (host_metrics, selections, event)
                host_s += time.perf_counter() - t_host
                host_steps += k_steps

                step_end = step + k_steps
                last_step = step_end - 1
                every = max(trainer.log_every, 1)
                if step // every != step_end // every or step == start_step:
                    if event is not None:
                        event.synchronize()
                    host = {}
                    for name, v in host_metrics.items():
                        if name.startswith("per_sample"):
                            continue
                        if v.dim() == 0:
                            host[name] = float(v)
                        elif k_steps > 1 and v.dim() == 1 and v.shape[0] == k_steps:
                            host[name] = float(v[-1])  # the dispatch's last step
                    if ramp is not None:
                        host["ramp/percep_scale"] = ramp.scale()
                        host["ramp/ber_ema"] = ramp.ema
                        if ramp.fx_gate > 0:
                            host["ramp/fx_on"] = float(inputs.fx_on)
                        if msg_freeze:
                            host["ramp/msg_on"] = float(ramp.msg_on())
                    if alt:
                        host["ramp/gen_on"] = inputs.gen_update_scale
                    acc = host_metrics["per_bit_acc"].numpy()
                    acc = acc[-1] if acc.ndim == 2 else acc
                    host["bits/acc_min"] = float(acc.min())
                    host["bits/n_below_chance"] = float((acc < 0.45).sum())
                    if curr is not None:
                        host["ramp/nbits_active"] = float(curr.n_active)
                        host["bits/acc_min_active"] = float(acc[: curr.n_active].min())
                    # host seconds per step spent on data, draws and the scheduler
                    host["time/host_s"] = host_s / host_steps
                    host_s, host_steps = 0.0, 0
                    tracker.update(last_step, host)
                    logger.info("step %d loss %.4f dec %.4f loc %.4f ber %.4f miou %.4f",
                                last_step, host["loss"], host["dec/loss"],
                                host["loc/loss"], host["train/ber"],
                                host["train/miou"])

                if is_main and trainer.dump_samples and (
                        step // cfg.sample_freq != step_end // cfg.sample_freq
                        or step_end >= total):
                    _dump_audio_samples(state, audios[-1], msgs[-1], trainer.ckpt_dir,
                                        step_end, sr, tracker=tracker)

                if (step // cfg.valid_freq != step_end // cfg.valid_freq
                        or step_end >= total):
                    if is_main:
                        _validate_and_save(state, cfg, trainer, tracker, scheduler,
                                           val_ds, val_rng, eval_effects, step,
                                           step_end, ramp, curr)
                    # the other ranks wait out rank 0's validation and
                    # checkpoint, inside the group's timeout
                    parallel.barrier()
                step = step_end
        if pending is not None:
            if pending[2] is not None:
                pending[2].synchronize()
            _feed_scheduler(scheduler, pending[0], pending[1])
    finally:
        profile.finish(step)
        batches.close()
        tracker.close()
    return state
