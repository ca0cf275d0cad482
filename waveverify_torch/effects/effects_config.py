"""YAML effects-config loader (a copy of
``waveverify_tpu/effects/effects_config.py``; reference
model/watermarking.py:55-181).

The reference loads ``conf/effects_config.yml`` at module import and falls
back to built-in defaults on any error. The rebuild keeps the same schema
(``effect_param_grid`` / ``train_effects`` / ``eval_effects`` /
``scheduler_config``) and the same fail-safe fallback, but loads explicitly
(no import-time side effects) so tests and the trainer control which file is
used.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "conf",
    "effects_config.yml",
)


@dataclass(frozen=True)
class EffectsConfig:
    """Resolved effects configuration.

    ``train_effects`` / ``eval_effects`` are (name, params) spec lists that
    feed :class:`~waveverify_torch.effects.effects.EffectBank` and the
    validation sweep; ``effect_param_grid`` and ``scheduler`` configure the
    host-side :class:`~waveverify_torch.effects.scheduler.EffectScheduler`.
    """

    train_effects: Tuple[Tuple[str, Dict[str, Any]], ...]
    eval_effects: Tuple[Tuple[str, Dict[str, Any]], ...]
    effect_param_grid: Dict[str, Dict[str, Any]]
    scheduler: Dict[str, float] = field(default_factory=dict)
    source: str = "defaults"

    @property
    def beta(self) -> float:
        return float(self.scheduler.get("beta", 0.9))

    @property
    def ber_threshold(self) -> float:
        return float(self.scheduler.get("ber_threshold", 0.001))

    @property
    def miou_threshold(self) -> float:
        return float(self.scheduler.get("miou_threshold", 0.95))


def _parse_spec_list(raw: Any) -> List[Tuple[str, Dict[str, Any]]]:
    specs: List[Tuple[str, Dict[str, Any]]] = []
    for entry in raw:
        name = entry["name"]
        params = dict(entry.get("params") or {})
        # 2-element list params become tuples (frequency ranges), matching
        # the reference's normalization (watermarking.py:104-109).
        for k, v in params.items():
            if isinstance(v, list) and len(v) == 2:
                params[k] = tuple(v)
        specs.append((str(name), params))
    if not specs:
        raise ValueError("empty effect spec list")
    return specs


def _defaults() -> EffectsConfig:
    from waveverify_torch.effects.effects import (
        DEFAULT_EVAL_EFFECTS,
        DEFAULT_TRAIN_EFFECTS,
    )
    from waveverify_torch.effects.scheduler import DEFAULT_EFFECT_PARAM_GRID

    return EffectsConfig(
        train_effects=tuple((n, dict(p)) for n, p in DEFAULT_TRAIN_EFFECTS),
        eval_effects=tuple((n, dict(p)) for n, p in DEFAULT_EVAL_EFFECTS),
        effect_param_grid={k: dict(v) for k, v in
                           DEFAULT_EFFECT_PARAM_GRID.items()},
        scheduler={"beta": 0.9, "ber_threshold": 0.001,
                   "miou_threshold": 0.95},
        source="defaults",
    )


def load_effects_config(path: Optional[str] = None) -> EffectsConfig:
    """Load an effects config YAML, falling back to defaults on any error.

    ``path=None`` tries the repo's ``conf/effects_config.yml`` (the
    reference resolves the same relative location,
    model/watermarking.py:77-82). The fallback-on-failure behavior matches
    the reference's ``load_effects_config`` exactly — a bad or missing file
    logs a warning and yields the built-in grid, never an exception.
    """
    cfg_path = path if path is not None else _DEFAULT_PATH
    try:
        import yaml

        with open(cfg_path, "r") as f:
            raw = yaml.safe_load(f)
        train = _parse_spec_list(raw["train_effects"])
        evals = _parse_spec_list(raw["eval_effects"])
        grid = {str(k): dict(v or {}) for k, v in
                raw["effect_param_grid"].items()}
        sched = {str(k): float(v) for k, v in
                 (raw.get("scheduler_config") or {}).items()}
        logger.info("loaded effects config from %s", cfg_path)
        return EffectsConfig(
            train_effects=tuple(train),
            eval_effects=tuple(evals),
            effect_param_grid=grid,
            scheduler=sched,
            source=str(cfg_path),
        )
    except Exception as exc:  # fail-safe like the reference (:117-119)
        logger.warning("failed to load effects config from %s (%s); "
                       "using defaults", cfg_path, exc)
        return _defaults()
