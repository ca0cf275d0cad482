"""Watermark detector: SEANet encoder + fused upsampling bit head
(counterpart of ``waveverify_tpu/models/detector.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from waveverify_torch.config import DetectorConfig
from waveverify_torch.modules.conv import (
    NormConv1d,
    NormConvTranspose1d,
    fused_upsample_head,
)
from waveverify_torch.modules.seanet import SEANetEncoder

DEFAULT_MESSAGE_THRESHOLD = 0.5


class Detector(nn.Module):
    """audio ``[B, 1, T]`` -> per-sample bit logits ``[B, T, nbits]``. The
    input is not pre-padded: the encoder's convs pad themselves."""

    def __init__(self, config: DetectorConfig = DetectorConfig()):
        super().__init__()
        d = self.config = config
        self.encoder = SEANetEncoder(
            channels=d.channels_audio, dimension=d.dimension,
            n_filters=d.channels_enc, n_fft_base=d.n_fft_base,
            n_residual_layers=d.n_residual_enc, ratios=tuple(d.strides),
            activation=d.activation, alpha=d.activation_alpha, norm=d.norm,
            kernel_size=d.kernel_size, last_kernel_size=d.last_kernel_size,
            residual_kernel_size=d.residual_kernel_size,
            dilation_base=d.dilation_base, skip=d.skip, causal=d.causal,
            pad_mode=d.pad_mode, act_all=d.act_all, expansion=d.expansion,
            groups=d.groups, l2norm=d.encoder_l2norm, use_bias=d.bias,
            spec=d.spec, spec_compression=d.spec_compression,
            res_scale=d.res_scale_enc, zero_init=d.zero_init,
            inout_norm=d.inout_norm)
        self.reverse_convolution = NormConvTranspose1d(
            d.dimension, d.output_dim, d.hop_length, stride=d.hop_length,
            norm="none", use_bias=True)
        self.last_layer = NormConv1d(d.output_dim, d.nbits, 1, norm="none",
                                     use_bias=True)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        z = self.encoder(audio, None)
        return fused_upsample_head(self.reverse_convolution, self.last_layer,
                                   z, audio.shape[-1])


def detector_postprocess(logits: torch.Tensor,
                         message_threshold: float = DEFAULT_MESSAGE_THRESHOLD
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's quirk path: softmax over bits, time mean, then a
    second sigmoid. logits ``[B, T, nbits]`` -> (bits int32, probs)."""
    probs = torch.softmax(logits, dim=-1)
    message_probabilities = torch.sigmoid(torch.mean(probs, dim=1))
    bits = (message_probabilities > message_threshold).to(torch.int32)
    return bits, message_probabilities


def detector_confidence(logits: torch.Tensor) -> torch.Tensor:
    """Mean over time and bits of sigmoid(logits): ``[B]``."""
    return torch.mean(torch.sigmoid(logits), dim=(1, 2))


def detector_bits(logits: torch.Tensor,
                  threshold: float = DEFAULT_MESSAGE_THRESHOLD) -> torch.Tensor:
    """Canonical decision: sigmoid, time mean, threshold -> ``[B, nbits]``."""
    probs = torch.mean(torch.sigmoid(logits), dim=1)
    return (probs > threshold).to(torch.int32)
