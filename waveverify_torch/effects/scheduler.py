"""Adaptive effect curriculum scheduler (host-side numpy; a copy of
``waveverify_tpu/effects/scheduler.py``, which the port does not import).

The reference scheduler's semantics
(reference utils/effect_scheduler.py:39-807):

- selection probabilities start uniform and are sampled WITH replacement;
- per-(param, value) success tracking: success = BER <= ber_threshold AND
  mIoU >= miou_threshold; choice weight = success_rate + 0.1 (0.5 neutral
  default for unexplored values) (reference :641-673);
- per-effect and per-param-combo EMA of BER/mIoU with beta (reference
  :309-430);
- ``adapt_effect_probabilities`` (softmax over reward
  0.8*(1-BER) + 0.2*mIoU, smoothing 0.8) exists but — exactly like the
  reference — is NEVER called from the training path (reference only calls
  it from its own __main__:897), so selection stays uniform in practice and
  the adaptivity comes from parameter-choice weighting. Preserved as-is.

This runs between train steps: it consumes per-sample scalar BER/mIoU
returned from the device and emits integer indices into an
:class:`~waveverify_torch.effects.effects.EffectBank` — no tensors, no sync
beyond the metrics the training loop already logs.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# conf/effects_config.yml:1-33 effect_param_grid
DEFAULT_EFFECT_PARAM_GRID: Dict[str, Dict[str, Any]] = {
    "identity": {},
    "highpass_filter": {"cutoff_freq": {"choices": [500, 3500]}},
    "lowpass_filter": {"cutoff_freq": {"choices": [1000, 2000]}},
    "bandpass_filter": {
        "cutoff_freq_low": {"choices": [300]},
        "cutoff_freq_high": {"choices": [4000]},
    },
    "speed": {"speed": {"choices": [0.8]}},
    "resample": {"new_sample_rate": {"choices": [32000]}},
    "random_noise": {"noise_std": {"choices": [0.001]}},
}


def make_hashable(value: Any):
    """Recursively convert lists/dicts to hashable tuples (reference :787-807)."""
    if isinstance(value, dict):
        return tuple(sorted((k, make_hashable(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(make_hashable(v) for v in value)
    return value


class EffectScheduler:
    """Adaptive attack curriculum over a static effect parameter grid."""

    def __init__(self, effect_params: Optional[Dict[str, Dict[str, Any]]] = None,
                 beta: float = 0.9, ber_threshold: float = 0.001,
                 miou_threshold: float = 0.95,
                 rng: Optional[np.random.RandomState] = None):
        self.effect_params = (
            dict(effect_params) if effect_params is not None
            else dict(DEFAULT_EFFECT_PARAM_GRID)
        )
        self.beta = beta
        self.ber_threshold = ber_threshold
        self.miou_threshold = miou_threshold
        self.rng = rng if rng is not None else np.random.RandomState()

        n = len(self.effect_params)
        self.effect_probabilities: Dict[str, float] = {
            name: 1.0 / n for name in self.effect_params
        }
        self.effect_metrics_history: Dict[str, Dict[str, Optional[float]]] = {}
        self.parameter_metrics_history: Dict[str, Dict[Any, Dict[str, Any]]] = (
            defaultdict(dict)
        )
        self.parameter_success_rates: Dict[str, Dict[Tuple, List[bool]]] = {}
        self.metric_history: Dict[str, Dict[str, Any]] = defaultdict(
            lambda: {"overall": {"ber": [], "miou": []}, "params": {}}
        )
        self.effect_usage_stats: Dict[str, int] = defaultdict(int)
        self.total_effects = 0
        # metric-update counter for the every-100-updates EMA dump; persisted
        # so the cadence continues across resume (the reference logs on its
        # persistent update count)
        self._updates = 0
        self._warned_combos: set = set()

    # -- selection -----------------------------------------------------------

    def select_effects(self, num_effects: int
                       ) -> List[Tuple[str, Dict[str, Any]]]:
        """Sample ``num_effects`` (effect, resolved-params) pairs by probability,
        with replacement (reference :181-246)."""
        if num_effects <= 0:
            raise ValueError(f"num_effects must be positive, got {num_effects}")
        names = list(self.effect_probabilities.keys())
        probs = np.array([self.effect_probabilities[n] for n in names], float)
        s = probs.sum()
        probs = probs / s if s > 0 else np.full(len(names), 1.0 / len(names))

        selected = self.rng.choice(
            names, size=min(num_effects, len(names)), replace=True, p=probs
        )
        out: List[Tuple[str, Dict[str, Any]]] = []
        for name in selected:
            params = self._resolve_effect_params(self.effect_params.get(name, {}),
                                                 name)
            out.append((str(name), params))
            self.effect_usage_stats[str(name)] += 1
            self.total_effects += 1
        return out

    def _resolve_effect_params(self, raw_params: Dict[str, Any],
                               effect_name: str) -> Dict[str, Any]:
        """Pick each parameter value weighted by its success rate + 0.1
        (reference :614-743), with the bandpass low<high repair."""
        resolved: Dict[str, Any] = {}
        for key, config in raw_params.items():
            if isinstance(config, dict) and "choices" in config:
                choices = config["choices"]
                if not choices:
                    continue
                weights = []
                for choice in choices:
                    hist = self.parameter_success_rates.get(effect_name, {}).get(
                        (key, make_hashable(choice))
                    )
                    rate = (sum(hist) / len(hist)) if hist else 0.5
                    weights.append(rate + 0.1)
                total = sum(weights)
                if total > 0:
                    idx = self.rng.choice(len(choices),
                                          p=[w / total for w in weights])
                else:
                    idx = self.rng.randint(len(choices))
                resolved[key] = choices[int(idx)]
            else:
                resolved[key] = config
        # bandpass repair: ensure low < high (reference :689-743)
        if ("cutoff_freq_low" in resolved and "cutoff_freq_high" in resolved
                and resolved["cutoff_freq_low"] >= resolved["cutoff_freq_high"]):
            lows = self.effect_params[effect_name]["cutoff_freq_low"]["choices"]
            highs = self.effect_params[effect_name]["cutoff_freq_high"]["choices"]
            pairs = [(lo, hi) for lo in lows for hi in highs if lo < hi]
            if pairs:
                lo, hi = pairs[self.rng.randint(len(pairs))]
                resolved["cutoff_freq_low"] = lo
                resolved["cutoff_freq_high"] = hi
        return resolved

    # -- metric feedback --------------------------------------------------------

    def update_effect_metrics(self, effect_name: str,
                              effect_params: Dict[str, Any],
                              localized_ber: float, miou: float) -> None:
        """EMA update + success tracking (reference :309-430)."""
        if effect_name not in self.effect_params:
            raise ValueError(f"Unknown effect: '{effect_name}'")
        if not 0 <= localized_ber <= 1:
            raise ValueError(f"BER must be in [0, 1], got {localized_ber}")
        if not 0 <= miou <= 1:
            raise ValueError(f"mIoU must be in [0, 1], got {miou}")

        beta = self.beta
        metrics = self.effect_metrics_history.setdefault(
            effect_name, {"ber": None, "miou": None}
        )
        metrics["ber"] = (
            localized_ber if metrics["ber"] is None
            else beta * metrics["ber"] + (1 - beta) * localized_ber
        )
        metrics["miou"] = (
            miou if metrics["miou"] is None
            else beta * metrics["miou"] + (1 - beta) * miou
        )

        hist = self.metric_history[effect_name]
        hist["overall"]["ber"].append(localized_ber)
        hist["overall"]["miou"].append(miou)
        param_key = make_hashable(effect_params)
        hist["params"].setdefault(param_key, {"ber": [], "miou": []})
        hist["params"][param_key]["ber"].append(localized_ber)
        hist["params"][param_key]["miou"].append(miou)

        is_success = (localized_ber <= self.ber_threshold
                      and miou >= self.miou_threshold)
        for pname, pvalue in effect_params.items():
            ptuple = (pname, make_hashable(pvalue))
            self.parameter_success_rates.setdefault(effect_name, {})
            self.parameter_success_rates[effect_name].setdefault(ptuple, [])
            self.parameter_success_rates[effect_name][ptuple].append(is_success)

        pm = self.parameter_metrics_history[effect_name].setdefault(
            param_key, {"ber": None, "miou": None, "count": 0}
        )
        if pm["ber"] is None:
            pm["ber"], pm["miou"] = localized_ber, miou
        else:
            pm["ber"] = beta * pm["ber"] + (1 - beta) * localized_ber
            pm["miou"] = beta * pm["miou"] + (1 - beta) * miou
        pm["count"] += 1

        # periodic behavior dump (reference model/watermarking.py:750-753
        # logs scheduler state every 100 metric updates)
        self._updates += 1
        if self._updates % 100 == 0:
            summary = {
                name: {"ber": round(m["ber"], 4) if m["ber"] is not None else None,
                       "miou": round(m["miou"], 4) if m["miou"] is not None else None}
                for name, m in self.effect_metrics_history.items()
            }
            logger.info("scheduler EMA after %d updates: %s",
                        self._updates, summary)

    def adapt_effect_probabilities(self) -> None:
        """Softmax over reward 0.8*(1-BER) + 0.2*mIoU, smoothing 0.8
        (reference :432-504). NOTE: off the training path by design — the
        reference never calls this during training, and the rebuild keeps
        that behavior for parity."""
        scores: Dict[str, float] = {}
        smoothing = 0.8
        for name in self.effect_params:
            pm = self.parameter_metrics_history.get(name, {})
            rewards = [
                0.8 * (1 - m["ber"]) + 0.2 * m["miou"]
                for m in pm.values()
                if m["ber"] is not None and m["miou"] is not None
            ]
            scores[name] = float(np.mean(rewards)) if rewards else 0.0

        names = list(scores.keys())
        arr = np.array([scores[n] for n in names])
        if np.all(arr == 0):
            new_probs = np.ones_like(arr) / len(arr)
        else:
            stable = arr - arr.max()
            e = np.exp(stable)
            new_probs = e / e.sum()
        for name, p in zip(names, new_probs):
            old = self.effect_probabilities[name]
            self.effect_probabilities[name] = smoothing * old + (1 - smoothing) * p
        total = sum(self.effect_probabilities.values())
        for name in self.effect_probabilities:
            self.effect_probabilities[name] /= total

    # -- EffectBank bridge -------------------------------------------------------

    def select_bank_indices(self, batch_size: int,
                            bank_specs: Sequence[Tuple[str, Dict[str, Any]]],
                            match_reference_cap: bool = False
                            ) -> Tuple[np.ndarray, List[Tuple[str, Dict]]]:
        """Select per-sample effects and map them onto EffectBank branch indices.

        Returns (indices [batch_size] int32, selections) where selections is
        the raw (name, params) list for metric feedback. Unknown (name,
        params) combos fall back to branch 0 (identity).

        Reference quirk: ``select_effects(batch)`` caps its output at the
        catalog size (reference :220 ``size=min(num_effects, len(names))``),
        so with batch 32 only the first 7 samples ever receive effects.
        ``match_reference_cap=True`` reproduces that (remaining samples get
        identity); the default fills the whole batch — strictly stronger
        robustness training, deviation documented here.
        """
        lookup = {
            (name, make_hashable(params)): i
            for i, (name, params) in enumerate(bank_specs)
        }
        selections: List[Tuple[str, Dict[str, Any]]] = []
        if match_reference_cap:
            selections = self.select_effects(batch_size)
        else:
            while len(selections) < batch_size:
                selections.extend(
                    self.select_effects(batch_size - len(selections))
                )
            selections = selections[:batch_size]
        idx = np.zeros(batch_size, np.int32)
        for i, (name, params) in enumerate(selections):
            combo = (name, make_hashable(params))
            branch = lookup.get(combo)
            if branch is None:
                # a YAML grid / bank drift would otherwise silently train
                # with identity attacks while the scheduler believes the
                # effect was applied — warn once per unknown combo
                if combo not in self._warned_combos:
                    self._warned_combos.add(combo)
                    logger.warning(
                        "scheduler selected %s%s which has no EffectBank "
                        "branch — falling back to branch 0 (%s); check that "
                        "the effects config grid matches the train bank",
                        name, dict(params),
                        bank_specs[0][0] if bank_specs else "?",
                    )
                branch = 0
            idx[i] = branch
        return idx, selections

    # -- checkpoint state ---------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "effect_probabilities": dict(self.effect_probabilities),
            "effect_metrics_history": self.effect_metrics_history,
            "parameter_success_rates": {
                k: {str(t): v for t, v in d.items()}
                for k, d in self.parameter_success_rates.items()
            },
            "effect_usage_stats": dict(self.effect_usage_stats),
            "total_effects": self.total_effects,
            "updates": self._updates,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.effect_probabilities.update(state.get("effect_probabilities", {}))
        self.effect_metrics_history = state.get("effect_metrics_history", {})
        self.effect_usage_stats = defaultdict(
            int, state.get("effect_usage_stats", {})
        )
        self.total_effects = state.get("total_effects", 0)
        self._updates = state.get("updates", 0)
        import ast

        raw = state.get("parameter_success_rates", {})
        self.parameter_success_rates = {
            k: {ast.literal_eval(t): v for t, v in d.items()}
            for k, d in raw.items()
        }
