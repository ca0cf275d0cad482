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
from waveverify_torch.train.step import train_step, val_step
from waveverify_torch.train.watermarking import (
    draw,
    eval_random_effects,
    forward_audio_sample,
)

logger = logging.getLogger(__name__)

DEFAULT_CKPT_DIR = "runs/torch_train"


class Tracker:
    """Per-step time, a JSONL history and the best validation loss."""

    def __init__(self, log_file: Optional[str] = None):
        self.best_val_loss = float("inf")
        self.log_file = Path(log_file) if log_file else None
        if self.log_file is not None:
            self.log_file.parent.mkdir(parents=True, exist_ok=True)
        self._t_last = time.perf_counter()
        self._last_step: Optional[int] = None

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
        return metrics

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


def feed_controllers(ramp: Optional[BerGatedRamp],
                     curr: Optional[NbitsCurriculum], train_ber,
                     per_bit_acc) -> None:
    """One step's feedback, as the JAX loop feeds it: the curriculum takes
    the per-bit accuracy; the ramp takes the active bits' BER when the
    curriculum is on, else ``train/ber``."""
    acc = np.asarray(per_bit_acc)
    if curr is not None:
        curr.update(acc)
        gate_ber = 1.0 - float(acc[: curr.n_active].mean())
    else:
        gate_ber = float(np.mean(np.asarray(train_ber)))
    if ramp is not None:
        ramp.update(gate_ber, k=1, per_bit_acc=acc,
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

    Not ported (the CLI refuses them by name): ``--num-devices``,
    ``--steps-per-dispatch``, ``--split-disc``, ``--tensorboard``,
    ``--wandb``, ``--profile-steps``.
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


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws: a function of (seed, step)
    alone, so a resumed run draws what an unbroken one would."""
    return torch.Generator().manual_seed((seed << 32) + step)


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Start copying a step's metrics to the host without waiting."""
    return {k: v.detach().to("cpu", non_blocking=True) for k, v in metrics.items()}


def _feed_scheduler(scheduler: EffectScheduler, metrics: Dict[str, Any],
                    selections: List[Tuple[str, Dict]]) -> None:
    """One scheduler update per sample from its BER and MIoU."""
    bers = np.asarray(metrics["per_sample_ber"])
    mious = np.asarray(metrics["per_sample_miou"])
    for i, (name, params) in enumerate(selections[:len(bers)]):
        scheduler.update_effect_metrics(name, params,
                                        float(np.clip(bers[i], 0.0, 1.0)),
                                        float(np.clip(mious[i], 0.0, 1.0)))


def _dump_audio_samples(state: TrainState, audio: torch.Tensor,
                        msg: torch.Tensor, ckpt_dir: str, step: int,
                        sample_rate: int, n: int = 2) -> None:
    """Write n (clean, watermarked) WAV pairs under
    ``<ckpt_dir>/samples/step_<step>``."""
    from waveverify_torch.api.audio_io import save_audio

    out_dir = Path(ckpt_dir) / "samples" / f"step_{step}"
    out_dir.mkdir(parents=True, exist_ok=True)
    _, watermarked = forward_audio_sample(state.models, audio[:n], msg[:n])
    clean, watermarked = audio[:n].cpu().numpy(), watermarked.cpu().numpy()
    for i in range(len(clean)):
        save_audio(clean[i], out_dir / f"{i}_clean.wav", sample_rate)
        save_audio(watermarked[i], out_dir / f"{i}_watermarked.wav", sample_rate)


def _validate_and_save(state: TrainState, cfg: TrainConfig,
                       trainer: TrainerConfig, tracker: Tracker,
                       scheduler: EffectScheduler, val_ds, val_rng,
                       eval_effects, step: int,
                       ramp: Optional[BerGatedRamp] = None,
                       curr: Optional[NbitsCurriculum] = None) -> None:
    """Validation, then the ``latest``, ``best`` and ``save_iters``
    checkpoints. Neither stops a long run: a failure is logged with its
    traceback and training goes on."""
    device = next(state.models.parameters()).device
    step_end = step + 1
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
        tracker.update(step, vmetrics, include_time=False)
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


def train(cfg: TrainConfig, trainer: TrainerConfig = TrainerConfig(),
          max_steps: Optional[int] = None, resume: bool = False) -> TrainState:
    """A training run; returns the final state. Runs on ``trainer.device``
    (``cuda`` by default; raises without a card). ``max_steps`` is the
    step count to stop at, counted from 0 (a resumed or restored run starts
    at its checkpoint's step)."""
    device = resolve_device(trainer.device)
    if device.type == "cuda":
        set_conv_precision(trainer.conv_precision or "highest")
    sr = cfg.generator.sample_rate
    lc = cfg.loss
    fx_cfg = load_effects_config(trainer.effects_config)
    bank = EffectBank(fx_cfg.train_effects, sr)
    eval_effects = list(fx_cfg.eval_effects)
    scheduler = EffectScheduler(
        effect_params=fx_cfg.effect_param_grid, beta=fx_cfg.beta,
        ber_threshold=fx_cfg.ber_threshold,
        miou_threshold=fx_cfg.miou_threshold,
        rng=np.random.RandomState(cfg.seed + 1))
    log_file = trainer.log_file or str(Path(trainer.ckpt_dir) / "train_log.jsonl")
    tracker = Tracker(log_file)
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
        meta = ckpt.load_checkpoint(trainer.ckpt_dir, "latest", state)
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
    start_step = state.step

    # on resume the data stream continues with fresh clips
    data_seed = cfg.seed + start_step
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

    batches = prefetch_batches(train_ds, cfg.batch_size, nbits, data_seed)
    pending = None  # (host metrics, selections, event) of the last step
    host_s, host_steps = 0.0, 0  # host time on data and the scheduler
    try:
        for step in range(start_step, total):
            t_host = time.perf_counter()
            inputs = step_inputs(step, ramp, curr, lc)
            audio_np, msg_np = next(batches)
            if inputs.fx_on:
                idx, selections = scheduler.select_bank_indices(cfg.batch_size,
                                                                bank.specs)
            else:  # the attack latch is closed: identity only
                idx = np.full(cfg.batch_size, identity, np.int32)
                selections = [bank.specs[identity]] * cfg.batch_size
            draws = draw(step_generator(cfg.seed, step), cfg.batch_size,
                         audio_np.shape[1], bank.random_specs, sr,
                         cfg.window_duration, jitter_hop).to(device)
            audio = torch.from_numpy(audio_np).to(device)
            msg = torch.from_numpy(msg_np).to(device)
            bit_mask = (None if inputs.bit_mask is None
                        else torch.from_numpy(inputs.bit_mask).to(device))
            host_s += time.perf_counter() - t_host
            metrics = train_step(
                state, cfg, bank, audio, msg, idx, draws,
                percep_scale=inputs.percep_scale, train_disc=inputs.train_disc,
                gen_update_scale=inputs.gen_update_scale,
                msg_update_scale=inputs.msg_update_scale, bit_mask=bit_mask)

            t_host = time.perf_counter()
            if pending is not None:
                if pending[2] is not None:
                    pending[2].synchronize()
                _feed_scheduler(scheduler, pending[0], pending[1])
                feed_controllers(ramp, curr, pending[0]["train/ber"].numpy(),
                                 pending[0]["per_bit_acc"].numpy())
            host_metrics = _to_host(metrics)
            event = None
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            pending = (host_metrics, selections, event)
            host_s += time.perf_counter() - t_host
            host_steps += 1

            step_end = step + 1
            every = max(trainer.log_every, 1)
            if step // every != step_end // every or step == start_step:
                if event is not None:
                    event.synchronize()
                host = {k: float(v) for k, v in host_metrics.items()
                        if v.dim() == 0}
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
                host["bits/acc_min"] = float(acc.min())
                host["bits/n_below_chance"] = float((acc < 0.45).sum())
                if curr is not None:
                    host["ramp/nbits_active"] = float(curr.n_active)
                    host["bits/acc_min_active"] = float(acc[: curr.n_active].min())
                # host seconds per step spent on data, draws and the scheduler
                host["time/host_s"] = host_s / host_steps
                host_s, host_steps = 0.0, 0
                tracker.update(step, host)
                logger.info("step %d loss %.4f dec %.4f loc %.4f ber %.4f miou %.4f",
                            step, host["loss"], host["dec/loss"],
                            host["loc/loss"], host["train/ber"],
                            host["train/miou"])

            if trainer.dump_samples and (step // cfg.sample_freq
                                         != step_end // cfg.sample_freq
                                         or step_end >= total):
                _dump_audio_samples(state, audio, msg, trainer.ckpt_dir,
                                    step_end, sr)

            if step // cfg.valid_freq != step_end // cfg.valid_freq or step_end >= total:
                _validate_and_save(state, cfg, trainer, tracker, scheduler,
                                   val_ds, val_rng, eval_effects, step, ramp,
                                   curr)
        if pending is not None:
            if pending[2] is not None:
                pending[2].synchronize()
            _feed_scheduler(scheduler, pending[0], pending[1])
    finally:
        batches.close()
    return state
