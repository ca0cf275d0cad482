"""The networks and a holder that applies them to ``[B, T]`` audio, as the
JAX package's ``WatermarkModels.apply_generator`` / ``apply_detector`` /
``apply_locator`` / ``apply_discriminator`` do."""

from __future__ import annotations

import torch
from torch import nn

from waveverify_torch.config import TrainConfig
from waveverify_torch.models.detector import (
    Detector,
    detector_bits,
    detector_confidence,
    detector_postprocess,
)
from waveverify_torch.models.discriminator import Discriminator
from waveverify_torch.models.generator import Generator
from waveverify_torch.models.locator import Locator

__all__ = ["Detector", "Discriminator", "Generator", "Locator", "WatermarkModels",
           "detector_bits", "detector_confidence", "detector_postprocess"]


class WatermarkModels(nn.Module):
    """Generator, detector and locator of one configuration, and with
    ``discriminator=True`` the training discriminator (serving leaves it
    out)."""

    def __init__(self, cfg: TrainConfig, discriminator: bool = False):
        super().__init__()
        self.generator = Generator(cfg.generator)
        self.detector = Detector(cfg.detector)
        self.locator = Locator(cfg.locator)
        self.discriminator = (Discriminator(cfg.discriminator)
                              if discriminator else None)

    def apply_generator(self, audio: torch.Tensor,
                        msg: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]`` -> watermark residual ``[B, T]``."""
        return self.generator(audio[:, None, :], msg)[:, 0, :]

    def apply_detector(self, audio: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]`` -> bit logits ``[B, T, nbits]``."""
        return self.detector(audio[:, None, :])

    def apply_locator(self, audio: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]`` -> presence logits ``[B, T]``."""
        return self.locator(audio[:, None, :])[..., 0]

    def apply_discriminator(self, audio: torch.Tensor):
        """audio ``[B, T]`` -> one list of feature maps per sub-discriminator,
        its logit map last."""
        return self.discriminator(audio)
