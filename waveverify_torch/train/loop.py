"""The training loop: data, the effect scheduler's selection and feedback,
JSONL logging, validation, checkpoints and sample dumps (counterpart of
the base path of ``waveverify_tpu/train/loop.py``'s ``train``).

Per step the host makes the next batch, picks each sample's attack
(integer indices into the bank), draws the step's randomness and enqueues
the step; the scheduler is fed the previous step's per-sample metrics
while the card runs the current one.
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
from waveverify_torch.train.state import TrainState, create_train_state
from waveverify_torch.train.step import check_supported, train_step, val_step
from waveverify_torch.train.watermarking import (
    draw,
    eval_noise_effects,
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


@dataclass(frozen=True)
class TrainerConfig:
    """Host-side options of a run.

    ``log_file`` None logs to ``<ckpt_dir>/train_log.jsonl``;
    ``init_weights`` warm-starts the three networks from a weights ``.npz``
    when no checkpoint is resumed (the discriminator, optimizers and step
    start fresh); ``conv_precision`` "highest" (or None) runs f32 with TF32
    off on the card, "high" or "default" allow TF32 in cuDNN and cuBLAS;
    """

    train_folders: Tuple[str, ...] = ()
    val_folders: Tuple[str, ...] = ()
    ckpt_dir: str = DEFAULT_CKPT_DIR
    log_file: Optional[str] = None
    init_weights: Optional[str] = None
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
                       eval_effects, step: int) -> None:
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
                      len(eval_noise_effects(eval_effects)),
                      cfg.generator.sample_rate, cfg.window_duration,
                      gp=False).to(device)
        vmetrics = {k: float(v) for k, v in val_step(
            state, cfg, vaudio, vmsg, vdraws, eval_effects).items()}
        tracker.update(step, vmetrics, include_time=False)
        logger.info("val @%d: loss %.4f ber %.4f miou %.4f", step_end,
                    vmetrics["val/loss"], vmetrics["val/ber"], vmetrics["val/miou"])
    except Exception:
        logger.exception("validation failed at step %d; continuing", step_end)
    host_state = {"step": step_end, "scheduler_state": scheduler.state_dict(),
                  "best_val_loss": tracker.best_val_loss,
                  "model_config": model_config_dict(cfg)}
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


def train(cfg: TrainConfig, trainer: TrainerConfig = TrainerConfig(),
          max_steps: Optional[int] = None, resume: bool = False) -> TrainState:
    """A training run; returns the final state. Runs on ``trainer.device``
    (``cuda`` by default; raises without a card)."""
    check_supported(cfg)
    device = resolve_device(trainer.device)
    if device.type == "cuda":
        set_conv_precision(trainer.conv_precision or "highest")
    sr = cfg.generator.sample_rate
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

    state = create_train_state(cfg, torch.Generator().manual_seed(cfg.seed),
                               device)
    if resume and "latest" in ckpt.checkpoint_tags(trainer.ckpt_dir):
        meta = ckpt.load_checkpoint(trainer.ckpt_dir, "latest", state)
        if meta.get("scheduler_state"):
            scheduler.load_state_dict(meta["scheduler_state"])
        tracker.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        logger.info("resumed from step %d", state.step)
    elif trainer.init_weights:
        ckpt.load_weights(state.models, trainer.init_weights)
        logger.info("warm-started from %s", trainer.init_weights)
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

    batches = prefetch_batches(train_ds, cfg.batch_size, nbits, data_seed)
    pending = None  # (host metrics, selections, event) of the last step
    host_s, host_steps = 0.0, 0  # host time on data and the scheduler
    try:
        for step in range(start_step, total):
            t_host = time.perf_counter()
            audio_np, msg_np = next(batches)
            idx, selections = scheduler.select_bank_indices(cfg.batch_size,
                                                            bank.specs)
            draws = draw(step_generator(cfg.seed, step), cfg.batch_size,
                         audio_np.shape[1], len(bank.noise_branches), sr,
                         cfg.window_duration, jitter_hop).to(device)
            audio = torch.from_numpy(audio_np).to(device)
            msg = torch.from_numpy(msg_np).to(device)
            host_s += time.perf_counter() - t_host
            metrics = train_step(state, cfg, bank, audio, msg, idx, draws)

            t_host = time.perf_counter()
            if pending is not None:
                if pending[2] is not None:
                    pending[2].synchronize()
                _feed_scheduler(scheduler, pending[0], pending[1])
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
                acc = host_metrics["per_bit_acc"].numpy()
                host["bits/acc_min"] = float(acc.min())
                host["bits/n_below_chance"] = float((acc < 0.45).sum())
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
                                   val_ds, val_rng, eval_effects, step)
        if pending is not None:
            if pending[2] is not None:
                pending[2].synchronize()
            _feed_scheduler(scheduler, pending[0], pending[1])
    finally:
        batches.close()
    return state
