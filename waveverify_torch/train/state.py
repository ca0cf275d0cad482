"""Training state: the four networks, two AdamW optimizers with their
per-step exponential decay, and the step count (counterpart of
``waveverify_tpu/train/state.py``).

The JAX package's optax chain, ``adamw`` over ``exponential_decay(lr,
transition_steps=1, rate=gamma)``, is torch's ``AdamW`` with an
``ExponentialLR`` stepped after each update: both apply ``p -= lr_t *
(m_hat / (sqrt(v_hat) + eps) + wd * p)`` with ``lr_t = lr * gamma^t``. The
decay mask (``msg_*`` / ``film_*`` exempt while ``decay_exclude_msg_path``)
and the per-network learning-rate multipliers become parameter groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch
from torch.optim import AdamW
from torch.optim.lr_scheduler import ExponentialLR

from waveverify_torch.config import OptimConfig, TrainConfig
from waveverify_torch.models import WatermarkModels
from waveverify_torch.modules.conv import init_params

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

