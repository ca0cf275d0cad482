"""Training CLI: ``python -m waveverify_torch.train [--config conf/base.yml]``.

The flags of the JAX package's trainer that its base path uses, with
``--device`` (default ``cuda``) in place of ``--platform`` and
``--pallas``. Without ``--config`` the run takes ``TrainConfig()``, which
equals ``conf/base.yml``; reading a YAML file or a ``--set`` value needs
PyYAML. The JAX trainer's other flags are accepted and raise
``ValueError`` naming themselves: they are not ported yet.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from waveverify_torch.config import load_config
from waveverify_torch.train.loop import DEFAULT_CKPT_DIR, TrainerConfig, train

# flag -> argparse default; any other value is refused
_UNSUPPORTED = {
    "num_devices": None,
    "steps_per_dispatch": 1,
    "split_disc": False,
    "init_meta": None,
    "reinit_msg_path": False,
    "tensorboard": None,
    "wandb": None,
    "profile_steps": None,
}


def _parse_set(values: Sequence[str], ap: argparse.ArgumentParser) -> dict:
    overrides = {}
    for kv in values:
        if "=" not in kv:
            ap.error(f"--set expects KEY=VALUE, got {kv!r}")
        try:
            import yaml
        except ImportError as exc:
            raise ImportError("--set needs PyYAML, which is not installed") from exc
        k, v = kv.split("=", 1)
        val = yaml.safe_load(v)
        if isinstance(val, str):  # YAML 1.1 reads '2e-4' as a string
            for cast in (int, float):
                try:
                    val = cast(val)
                    break
                except ValueError:
                    pass
        overrides[k.strip()] = val
    return overrides


def main(argv: Optional[Sequence[str]] = None) -> None:
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
    ap.add_argument("--no-samples", action="store_true",
                    help="no WAV sample dumps")
    ap.add_argument("-v", "--verbose", action="store_true")
    # the JAX trainer's flags that are not ported yet
    ap.add_argument("--num-devices", type=int, default=None)
    ap.add_argument("--steps-per-dispatch", type=int, default=1)
    ap.add_argument("--split-disc", action="store_true")
    ap.add_argument("--init-meta", default=None)
    ap.add_argument("--reinit-msg-path", action="store_true")
    ap.add_argument("--tensorboard", default=None)
    ap.add_argument("--wandb", default=None)
    ap.add_argument("--profile-steps", default=None)
    args = ap.parse_args(argv)

    for name, default in _UNSUPPORTED.items():
        if getattr(args, name) != default:
            raise ValueError(f"--{name.replace('_', '-')} is not supported by "
                             "the PyTorch trainer yet")

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    overrides = _parse_set(args.set, ap)
    for key in ("batch_size", "val_batch_size", "train_duration", "val_duration"):
        if getattr(args, key) is not None:
            overrides[key] = getattr(args, key)
    if args.no_remat:
        overrides["remat"] = False
    cfg = load_config(args.config, overrides)
    trainer = TrainerConfig(
        train_folders=tuple(args.train_folders),
        val_folders=tuple(args.val_folders),
        ckpt_dir=args.ckpt_dir,
        log_file=args.log_file,
        init_weights=args.init_weights,
        log_every=args.log_every,
        dump_samples=not args.no_samples,
        effects_config=args.effects_config,
        conv_precision=args.conv_precision,
        device=args.device,
    )
    train(cfg, trainer, max_steps=args.max_steps, resume=args.resume)


if __name__ == "__main__":
    main()
