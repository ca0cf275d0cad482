"""The serving networks and a holder that applies them to ``[B, T]``
audio, as the JAX package's ``WatermarkModels.apply_generator`` /
``apply_detector`` / ``apply_locator`` do."""

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
from waveverify_torch.models.generator import Generator
from waveverify_torch.models.locator import Locator

__all__ = ["Detector", "Generator", "Locator", "WatermarkModels",
           "detector_bits", "detector_confidence", "detector_postprocess"]


class WatermarkModels(nn.Module):
    """Generator, detector and locator of one configuration."""

    def __init__(self, cfg: TrainConfig):
        super().__init__()
        self.generator = Generator(cfg.generator)
        self.detector = Detector(cfg.detector)
        self.locator = Locator(cfg.locator)

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
