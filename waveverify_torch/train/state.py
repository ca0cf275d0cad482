"""Training state: the four networks, two AdamW optimizers with their
per-step exponential decay, and the step count (counterpart of
``waveverify_tpu/train/state.py``).

The JAX package's optax chain, ``adamw`` over ``exponential_decay(lr,
transition_steps=1, rate=gamma)``, is torch's ``AdamW`` with an
``ExponentialLR`` stepped after each update: both apply ``p -= lr_t *
(m_hat / (sqrt(v_hat) + eps) + wd * p)`` with ``lr_t = lr * gamma^t``. The
decay mask (``msg_*`` / ``film_*`` exempt while ``decay_exclude_msg_path``)
and the per-network learning-rate multipliers become parameter groups.

:func:`load_jax_state` carries a JAX TrainState (as
``waveverify_torch.train.ocdbt.read_state`` reads it from an orbax
checkpoint) into a :class:`TrainState`: the optax chain's state
``[ScaleByAdamState(count, mu, nu), MaskedState, ScaleByScheduleState(count)]``
becomes each parameter's ``step`` / ``exp_avg`` / ``exp_avg_sq`` and the
schedule's position; under the per-network multipliers the watermarking
optimizer is an ``optax.multi_transform`` holding one such chain per
network (``inner_states.<net>.inner_state``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.optim import AdamW
from torch.optim.lr_scheduler import ExponentialLR

from waveverify_torch.config import OptimConfig, TrainConfig
from waveverify_torch.models import WatermarkModels
from waveverify_torch.modules.conv import init_params
from waveverify_torch.weights import flatten, load_params, torch_arrays

WEIGHT_DECAY = 0.01
EPS = 1e-8
WM_NETS = ("generator", "detector", "locator")


def in_msg_path(name: str) -> bool:
    """Whether a parameter (dotted module path) belongs to the message path:
    a part of its path starts with ``msg_`` or ``film_`` (the JAX package's
    predicate for the decay mask, the message-path freeze and the
    ``--reinit-msg-path`` graft)."""
    return any(part.startswith(("msg_", "film_")) for part in name.split("."))


def _decays(name: str, cfg: OptimConfig) -> bool:
    """Whether a parameter (dotted module path) takes weight decay."""
    return not (cfg.decay_exclude_msg_path and in_msg_path(name))


def wm_param_groups(models: WatermarkModels, cfg: OptimConfig
                    ) -> List[Dict[str, Any]]:
    """The watermarking optimizer's groups: per network (its lr
    multiplier), with and without weight decay."""
    mult = {"generator": cfg.generator_lr_mult,
            "detector": cfg.detector_lr_mult, "locator": 1.0}
    groups = []
    for net in WM_NETS:
        named = list(getattr(models, net).named_parameters())
        for decay in (True, False):
            params = [p for n, p in named if _decays(n, cfg) == decay]
            if params:
                groups.append({"params": params, "lr": cfg.lr * mult[net],
                               "weight_decay": WEIGHT_DECAY if decay else 0.0,
                               "name": f"{net}/{'decay' if decay else 'no_decay'}"})
    return groups


def make_optimizer(groups, cfg: OptimConfig):
    """(AdamW, its ExponentialLR) over ``groups``."""
    opt = AdamW(groups, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=EPS,
                weight_decay=WEIGHT_DECAY)
    return opt, ExponentialLR(opt, gamma=cfg.exp_gamma)


@dataclass
class TrainState:
    """Everything a training step changes."""

    models: WatermarkModels
    wm_opt: AdamW
    wm_sched: ExponentialLR
    disc_opt: AdamW
    disc_sched: ExponentialLR
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"models": self.models.state_dict(),
                "wm_opt": self.wm_opt.state_dict(),
                "wm_sched": self.wm_sched.state_dict(),
                "disc_opt": self.disc_opt.state_dict(),
                "disc_sched": self.disc_sched.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.models.load_state_dict(state["models"])
        self.wm_opt.load_state_dict(state["wm_opt"])
        self.wm_sched.load_state_dict(state["wm_sched"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        self.disc_sched.load_state_dict(state["disc_sched"])
        self.step = int(state["step"])


def create_train_state(cfg: TrainConfig, generator: torch.Generator,
                       device: torch.device) -> TrainState:
    """The four networks drawn from ``generator`` (a CPU generator, so a
    seed gives the same parameters on every device), moved to ``device``,
    and their optimizers.

    The watermarking parameters start with zero gradients (not None) and
    are zeroed, not freed, between steps: a parameter no loss reaches (the
    detector's and locator's unused message layers) then still takes its
    AdamW update, as it does in optax."""
    models = WatermarkModels(cfg, discriminator=True)
    init_params(models, generator)
    models.to(device)
    for net in WM_NETS:
        for p in getattr(models, net).parameters():
            p.grad = torch.zeros_like(p)
    wm_opt, wm_sched = make_optimizer(wm_param_groups(models, cfg.optim),
                                      cfg.optim)
    disc_opt, disc_sched = make_optimizer(
        [{"params": list(models.discriminator.parameters())}], cfg.optim)
    return TrainState(models, wm_opt, wm_sched, disc_opt, disc_sched)



def _adamw_chain(tree: Any) -> Optional[Tuple[Any, Any, Any, Any]]:
    """(count, mu, nu, schedule count) of an optax ``adamw`` chain's
    state, or None when ``tree`` is not one."""
    try:
        adam, masked, sched = tree
        if set(adam) != {"count", "mu", "nu"} or set(sched) != {"count"}:
            return None
        if set(masked) != {"inner_state"}:
            return None
        return adam["count"], adam["mu"], adam["nu"], sched["count"]
    except (TypeError, ValueError, KeyError):
        return None


def _wm_chains(tree: Any, multi: bool) -> Optional[Dict[str, Tuple[Any, Any, Any, Any]]]:
    """Each watermarking network's (count, mu, nu, schedule count) in the
    layout the config builds, or None when the tree has another."""
    if multi:
        inner = tree.get("inner_states") if isinstance(tree, dict) else None
        if not isinstance(inner, dict) or set(inner) != set(WM_NETS):
            return None
        chains = {net: _adamw_chain(inner[net].get("inner_state"))
                  for net in WM_NETS}
        if any(c is None for c in chains.values()):
            return None
        return {net: (c[0], c[1][net], c[2][net], c[3]) for net, c in chains.items()}
    chain = _adamw_chain(tree)
    if chain is None:
        return None
    return {net: (chain[0], chain[1][net], chain[2][net], chain[3]) for net in WM_NETS}


def _set_adam(opt: AdamW, module: torch.nn.Module, net: str, count: Any,
              mu: Any, nu: Any) -> None:
    """AdamW's state of ``module``'s parameters from optax's moments (flax
    layouts) and update count."""
    m, _ = torch_arrays(module, flatten(mu, net), net)
    v, _ = torch_arrays(module, flatten(nu, net), net)
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(m[name], dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.tensor(v[name], dtype=p.dtype, device=p.device)}


def _set_schedule(opt: AdamW, sched: ExponentialLR, counts: Dict[str, int]) -> None:
    """Each group's learning rate after ``counts[<its network>]`` decays,
    and the schedule's position."""
    for group in opt.param_groups:
        t = counts[group.get("name", "discriminator").split("/")[0]]
        group["lr"] = group["initial_lr"] * sched.gamma ** t
    sched.last_epoch = max(counts.values())
    sched._last_lr = [group["lr"] for group in opt.param_groups]


def load_jax_state(state: TrainState, raw: Dict[str, Any], cfg: OptimConfig) -> bool:
    """Carry the JAX TrainState tree ``raw`` into ``state`` (built from the
    same config): ``wm_params`` and ``disc_params`` into the networks
    (a missing, extra or misshapen leaf raises) and ``step``; and, when
    both optimizer trees have the layouts ``cfg`` builds, their moments,
    counts and schedule positions. Returns whether the optimizer state was
    carried; when not, the optimizers stay fresh, as the JAX loop's
    params-only resume leaves them."""
    models = state.models
    flat = flatten(raw["wm_params"])
    consumed = set()
    for net in WM_NETS:
        consumed |= load_params(getattr(models, net), flat, net)
    extra = sorted(set(flat) - consumed)
    if extra:
        raise KeyError(f"wm_params entries no network takes: {extra[:5]}")
    load_params(models.discriminator, flatten(raw["disc_params"], "discriminator"),
                "discriminator")
    state.step = int(np.asarray(raw["step"]))
    # the JAX package builds an optax.multi_transform when a multiplier is set
    multi = cfg.detector_lr_mult != 1.0 or cfg.generator_lr_mult != 1.0
    wm = _wm_chains(raw.get("wm_opt_state"), multi)
    disc = _adamw_chain(raw.get("disc_opt_state"))
    if wm is None or disc is None:
        return False
    for net, (count, mu, nu, _) in wm.items():
        _set_adam(state.wm_opt, getattr(models, net), net, count, mu, nu)
    _set_schedule(state.wm_opt, state.wm_sched,
                  {net: int(np.asarray(c[3])) for net, c in wm.items()})
    _set_adam(state.disc_opt, models.discriminator, "discriminator", *disc[:3])
    _set_schedule(state.disc_opt, state.disc_sched,
                  {"discriminator": int(np.asarray(disc[3]))})
    return True
