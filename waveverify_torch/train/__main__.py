"""Training CLI: ``python -m waveverify_torch.train [--config conf/base.yml]``.

The JAX package's trainer flags, with ``--device`` (default ``cuda``) in
place of ``--platform`` and ``--pallas`` (the port has no switch that
turns its kernel off on the card). Without ``--config`` the run takes
``TrainConfig()``, which equals ``conf/base.yml``; reading a YAML file or
a list or mapping given to ``--set`` needs PyYAML. Every ``--set
warmup.*`` knob is ported (the training controllers), and so are
``--init-weights``,
``--init-meta`` and ``--reinit-msg-path``: the r5 recipe
(``scripts/train_demo_r5.sh``) continues from its committed snapshot with

    python -m waveverify_torch.train --ckpt-dir runs/r5 \
        --init-weights weights/snapshots/demo_r5_latest.npz \
        --init-meta weights/snapshots/demo_r5_latest_meta.json \
        --batch-size 16 --no-remat --set train_duration=0.9 ... (the
        script's --set flags)

So are the JAX trainer's other options: ``--split-disc``,
``--steps-per-dispatch``, ``--effect-dispatch``, ``--profile-steps``
(a ``torch.profiler`` Chrome trace that also carries the port's spans of
those steps: each step's forward, discriminator update, generator
backward and update, with their device times),
``--tensorboard``, ``--wandb`` (a warning and the
JSONL log where wandb does not import) and ``--debug-nans`` (autograd's
anomaly mode and a finiteness check per step).

``--num-devices N`` trains data parallel over N devices, one process
(rank) per device, as the JAX trainer does over its mesh
(:mod:`waveverify_torch.parallel`): ``batch_size`` must divide over N,
each rank feeds its share of every step, and only rank 0 logs, validates
and checkpoints. Under ``torchrun`` the command joins the group torchrun
made (N, when given, must be its world size); otherwise, with N > 1, the
command starts the N ranks itself on this host, with a rendezvous on
localhost, so the JAX command line works unchanged::

    python -m waveverify_torch.train --num-devices 4 ...
    torchrun --nproc_per_node 4 -m waveverify_torch.train ...

On ``cuda`` the ranks talk over NCCL, one card each (more ranks than
cards raises); ``--device cpu`` runs them over gloo. A rank that fails
makes the command fail.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional, Sequence, Tuple

import torch

from waveverify_torch import parallel
from waveverify_torch.config import TrainConfig, load_config
from waveverify_torch.train.loop import DEFAULT_CKPT_DIR, TrainerConfig, train


_WORDS = {"true": True, "yes": True, "on": True, "false": False, "no": False,
          "off": False, "null": None, "~": None, "": None}


def _read_value(v: str):
    """One ``--set`` value, read the same on every machine: a list or
    mapping (``[...]`` / ``{...}``) as YAML, which needs PyYAML; any other
    value is a scalar read here: quotes make a string, YAML's booleans and
    null (any case) their value, then an int, a float, or else the string
    (so ``2e-4`` is a float, which YAML 1.1 would read as a string)."""
    v = v.strip()
    if v.startswith(("[", "{")):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"--set value {v!r} is a list or mapping, which "
                              "needs PyYAML") from e
        return yaml.safe_load(v)
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1]
    if v.lower() in _WORDS:
        return _WORDS[v.lower()]
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def _parse_set(values: Sequence[str], ap: argparse.ArgumentParser) -> dict:
    """``--set KEY=VALUE`` overrides, each value read by :func:`_read_value`."""
    overrides = {}
    for kv in values:
        if "=" not in kv:
            ap.error(f"--set expects KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        overrides[k.strip()] = _read_value(v)
    return overrides


def parse(argv: Optional[Sequence[str]] = None
          ) -> Tuple[TrainConfig, TrainerConfig, Optional[int], bool, bool]:
    """The run the flags describe: ``(config, trainer options, max steps,
    resume, verbose)``; raises ``ValueError`` when ``batch_size`` does not
    divide over ``--num-devices``."""
    ap = argparse.ArgumentParser(description="Train waveverify with PyTorch")
    ap.add_argument("--config", default=None,
                    help="YAML of the conf/base.yml schema (default: the "
                    "built-in TrainConfig, equal to conf/base.yml)")
    ap.add_argument("--effects-config", default=None,
                    help="effects YAML (conf/effects_config.yml schema)")
    ap.add_argument("--train-folders", nargs="*", default=[],
                    help="folders of training WAVs (synthetic audio if empty)")
    ap.add_argument("--val-folders", nargs="*", default=[])
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR,
                    help="checkpoints, samples and the default log")
    ap.add_argument("--log-file", default=None,
                    help="JSONL log (default <ckpt-dir>/train_log.jsonl)")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--val-batch-size", type=int, default=None)
    ap.add_argument("--train-duration", type=float, default=None)
    ap.add_argument("--val-duration", type=float, default=None)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--conv-precision", default=None,
                    choices=["highest", "high", "default"],
                    help="highest (default): f32 with TF32 off on the card; "
                    "high / default: TF32 allowed in cuDNN and cuBLAS")
    ap.add_argument("--no-remat", action="store_true",
                    help="keep the forward's activations instead of "
                    "recomputing them in the backward pass")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="override a config key in conf/base.yml's schema, "
                    "e.g. --set AdamW.lr=2e-4 --set valid_freq=100")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <ckpt-dir>/latest")
    ap.add_argument("--init-weights", default=None, metavar="NPZ",
                    help="warm-start the three networks from a weights .npz "
                    "when no checkpoint is resumed")
    ap.add_argument("--init-meta", default=None, metavar="JSON",
                    help="with --init-weights: a checkpoint meta.json whose "
                    "step count and scheduler, ramp and nbits-curriculum "
                    "states the run continues from")
    ap.add_argument("--reinit-msg-path", action="store_true",
                    help="after the warm start, replace the msg_* / film_* "
                    "parameters with fresh ones (skipped when --resume "
                    "found a checkpoint)")
    ap.add_argument("--no-samples", action="store_true",
                    help="no WAV sample dumps")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K training steps per call; the controllers' inputs "
                    "are held and the scheduler and controllers are fed once "
                    "per K steps, and the run ends at a multiple of K")
    ap.add_argument("--effect-dispatch", default="stack",
                    choices=["stack", "scan"],
                    help="EffectBank dispatch: 'stack' draws each random "
                    "branch once for the batch; 'scan' draws per sample, as "
                    "each sample ran its branch alone")
    ap.add_argument("--split-disc", action="store_true",
                    help="update the discriminator in a step of its own, on a "
                    "no-grad generator forward, before the generator's step "
                    "(same order and draws; one extra generator forward on "
                    "steps where the discriminator trains)")
    ap.add_argument("--tensorboard", default=None, metavar="DIR",
                    help="also mirror scalars to TensorBoard events in DIR")
    ap.add_argument("--wandb", default=None, metavar="PROJECT",
                    help="mirror metrics + audio samples to a wandb project "
                    "(no-ops with a warning when wandb is not installed)")
    ap.add_argument("--profile-steps", default=None, metavar="START:STOP",
                    help="torch.profiler trace of steps [START, STOP) to "
                    "<ckpt-dir>/profile, with the port's spans of each step "
                    "(its phases and their device times) on a "
                    "track of their own")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly mode and a finiteness check of "
                    "each step's losses and gradient norms: fail fast on the "
                    "first NaN with FloatingPointError")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data parallel over N devices, one rank each (default: "
                    "torchrun's world size, else 1); outside torchrun the "
                    "command starts the N ranks itself")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    profile_start = profile_stop = None
    if args.profile_steps:
        profile_start, profile_stop = (int(v) for v in args.profile_steps.split(":"))
    overrides = _parse_set(args.set, ap)
    for key in ("batch_size", "val_batch_size", "train_duration", "val_duration"):
        if getattr(args, key) is not None:
            overrides[key] = getattr(args, key)
    if args.no_remat:
        overrides["remat"] = False
    cfg = load_config(args.config, overrides)
    if args.num_devices is not None and cfg.batch_size % args.num_devices:
        raise ValueError(f"batch_size {cfg.batch_size} must divide over "
                         f"{args.num_devices} devices")
    trainer = TrainerConfig(
        train_folders=tuple(args.train_folders),
        val_folders=tuple(args.val_folders),
        ckpt_dir=args.ckpt_dir,
        log_file=args.log_file,
        init_weights=args.init_weights,
        init_meta=args.init_meta,
        reinit_msg_path=args.reinit_msg_path,
        log_every=args.log_every,
        dump_samples=not args.no_samples,
        effects_config=args.effects_config,
        conv_precision=args.conv_precision,
        device=args.device,
        steps_per_dispatch=args.steps_per_dispatch,
        split_disc_step=args.split_disc,
        effect_dispatch=args.effect_dispatch,
        profile_start=profile_start,
        profile_stop=profile_stop,
        tensorboard_dir=args.tensorboard,
        wandb_project=args.wandb,
        debug_nans=args.debug_nans,
        num_devices=args.num_devices,
    )
    return cfg, trainer, args.max_steps, args.resume, args.verbose


def _check_cards(n: int, device: str) -> None:
    """Raise when ``n`` ranks on ``device`` would need more cards than
    are visible (one card per rank under NCCL)."""
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"--num-devices {n}: {n} ranks need {n} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")


def main(argv: Optional[Sequence[str]] = None) -> None:
    cfg, trainer, max_steps, resume, verbose = parse(argv)
    n = trainer.num_devices
    if "WORLD_SIZE" not in os.environ and n is not None and n > 1:
        # outside torchrun: start the ranks here; each runs this function
        # again under torchrun's environment
        _check_cards(n, trainer.device)
        parallel.spawn(main, n, list(sys.argv[1:] if argv is None else argv))
        return
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    parallel.initialize_distributed(device=trainer.device)
    train(cfg, trainer, max_steps=max_steps, resume=resume)
    parallel.destroy()


if __name__ == "__main__":
    main()
