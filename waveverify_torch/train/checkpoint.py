"""Training checkpoints, in the reference's tag layout (counterpart of
``waveverify_tpu/train/checkpoint.py``)::

    <ckpt_dir>/<tag>/state.pt      models, optimizers, schedules, step
    <ckpt_dir>/<tag>/meta.json     host state: step, effect scheduler, best
                                   validation loss, model-config snapshot
    <ckpt_dir>/<tag>/weights.npz   the watermarking networks in the JAX
                                   package's save_weights_npz format

A tag is written into a temporary directory and renamed into place. The
JAX package's orbax checkpoints are not read (reading them needs JAX):
:func:`orbax_refusal` names the JAX package's route to an ``.npz``.

In a data-parallel run (``waveverify_torch.parallel``) the training loop
has rank 0 alone write, while the other ranks wait at a barrier; on resume
every rank reads ``latest`` after a barrier, and rank 0's state is then
broadcast, so the replicas start equal.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from waveverify_torch.config import TrainConfig, model_config_dict
from waveverify_torch.models import WatermarkModels
from waveverify_torch.train.state import WM_NETS, TrainState
from waveverify_torch.weights import export_params, load_params, read_npz, write_npz


def orbax_refusal(path: Union[str, Path]) -> str:
    """The error for an orbax checkpoint directory, with the route from it
    to a weights ``.npz`` the port reads."""
    return (f"{path} is an orbax checkpoint of the JAX trainer, which the "
            "port does not read (it needs JAX). Convert it where JAX runs: "
            "params = waveverify_tpu.train.checkpoint.load_params(<ckpt root>, "
            "<tag>), then waveverify_tpu.convert.save_weights_npz(params, "
            "'weights.npz', config=<its TrainConfig>); the port reads that "
            ".npz (WaveVerify, --init-weights).")


def save_weights(models: WatermarkModels, path: Union[str, Path],
                 cfg: TrainConfig) -> Path:
    """The generator, detector and locator as a ``save_weights_npz`` file
    (f16, '/'-joined flax paths, ``__config__``), which both the port's
    ``WaveVerify`` and the JAX package's ``load_weights_npz`` read."""
    flat: Dict[str, Any] = {}
    for net in WM_NETS:
        flat.update(export_params(getattr(models, net), net))
    return write_npz(path, flat, model_config_dict(cfg))


def load_weights(models: WatermarkModels, path: Union[str, Path]) -> None:
    """Warm start: copy a ``save_weights_npz`` file's three networks into
    ``models``; raises on a missing, extra or misshapen entry."""
    flat, _ = read_npz(path)
    consumed = set()
    for net in WM_NETS:
        consumed |= load_params(getattr(models, net), flat, net)
    extra = sorted(set(flat) - consumed)
    if extra:
        raise KeyError(f"{path}: entries no network takes: {extra[:5]}")


def save_checkpoint(ckpt_dir: Union[str, Path], tag: str, state: TrainState,
                    cfg: TrainConfig,
                    host_state: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``tag`` atomically and return its directory."""
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f".tmp_{tag}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    torch.save(state.state_dict(), tmp / "state.pt")
    (tmp / "meta.json").write_text(json.dumps(host_state or {}, default=str))
    save_weights(state.models, tmp / "weights.npz", cfg)
    target = root / tag
    if target.exists():
        shutil.rmtree(target)
    tmp.rename(target)
    return target


def load_checkpoint(ckpt_dir: Union[str, Path], tag: str,
                    state: TrainState) -> Dict[str, Any]:
    """Restore ``tag`` into ``state`` (built from the same config) and
    return its host state."""
    path = Path(ckpt_dir) / tag
    if not (path / "state.pt").exists():
        if (path / "state").is_dir():
            raise ValueError(orbax_refusal(path))
        raise FileNotFoundError(f"no checkpoint at {path}")
    device = next(state.models.parameters()).device
    state.load_state_dict(torch.load(path / "state.pt", map_location=device,
                                     weights_only=True))
    meta = path / "meta.json"
    return json.loads(meta.read_text()) if meta.exists() else {}


def checkpoint_tags(ckpt_dir: Union[str, Path]) -> List[str]:
    root = Path(ckpt_dir)
    if not root.exists():
        return []
    return sorted(p.name for p in root.iterdir()
                  if p.is_dir() and not p.name.startswith(".tmp"))
