"""Watermark locator: small SEANet encoder + presence-mask head
(counterpart of ``waveverify_tpu/models/locator.py``)."""

from __future__ import annotations

import torch
from torch import nn

from waveverify_torch.config import LocatorConfig
from waveverify_torch.modules.conv import (
    NormConv1d,
    NormConvTranspose1d,
    fused_upsample_head,
)
from waveverify_torch.modules.seanet import SEANetEncoder


class Locator(nn.Module):
    """audio ``[B, 1, T]`` -> presence logits ``[B, T, 1]``.

    The encoder runs with no message, so its FiLM and message-MLP
    parameters exist (a checkpoint carries them) but are never used. The
    hop is ``prod(strides)`` (32 for (8, 4)), and the head is a k = stride
    transposed conv followed by a 1x1 conv down to one channel. The input
    is not pre-padded: the encoder's convs pad themselves."""

    def __init__(self, config: LocatorConfig = LocatorConfig()):
        super().__init__()
        c = self.config = config
        self.encoder = SEANetEncoder(
            channels=c.channels_audio, dimension=c.dimension,
            n_filters=c.channels_enc, n_fft_base=c.n_fft_base,
            n_residual_layers=c.n_residual_enc, ratios=tuple(c.strides),
            activation=c.activation, alpha=c.activation_alpha, norm=c.norm,
            kernel_size=c.kernel_size, last_kernel_size=c.last_kernel_size,
            residual_kernel_size=c.residual_kernel_size,
            dilation_base=c.dilation_base, skip=c.skip, causal=c.causal,
            pad_mode=c.pad_mode, act_all=c.act_all, expansion=c.expansion,
            groups=c.groups, l2norm=c.encoder_l2norm, use_bias=c.bias,
            spec=c.spec, spec_compression=c.spec_compression,
            res_scale=c.res_scale_enc, zero_init=c.zero_init,
            inout_norm=c.inout_norm)
        self.reverse_convolution = NormConvTranspose1d(
            c.dimension, c.output_dim, c.hop_length, stride=c.hop_length,
            norm="none", use_bias=True)
        self.last_layer = NormConv1d(c.output_dim, 1, 1, norm="none",
                                     use_bias=True)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        z = self.encoder(audio, None)
        return fused_upsample_head(self.reverse_convolution, self.last_layer,
                                   z, audio.shape[-1])
