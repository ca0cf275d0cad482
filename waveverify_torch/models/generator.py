"""Watermark generator: FiLM-conditioned SEANet encoder/decoder that emits
an additive residual the length of its input (counterpart of
``waveverify_tpu/models/generator.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from waveverify_torch.config import GeneratorConfig
from waveverify_torch.modules.seanet import SEANetDecoder, SEANetEncoder


class Generator(nn.Module):
    """audio ``[B, 1, T]``, msg ``[B, nbits]`` -> residual ``[B, 1, T]``."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        g = self.config = config
        common = dict(
            channels=g.channels_audio, dimension=g.dimension,
            ratios=tuple(g.strides), activation=g.activation,
            alpha=g.activation_alpha, norm=g.norm, kernel_size=g.kernel_size,
            last_kernel_size=g.last_kernel_size,
            residual_kernel_size=g.residual_kernel_size,
            dilation_base=g.dilation_base, skip=g.skip, causal=g.causal,
            pad_mode=g.pad_mode, act_all=g.act_all, expansion=g.expansion,
            groups=g.groups, use_bias=g.bias, zero_init=g.zero_init,
            inout_norm=g.inout_norm)
        self.encoder = SEANetEncoder(
            msg_dimension=g.msg_dimension, n_filters=g.channels_enc,
            n_fft_base=g.n_fft_base, n_residual_layers=g.n_residual_enc,
            l2norm=g.encoder_l2norm, spec=g.spec,
            spec_compression=g.spec_compression, res_scale=g.res_scale_enc,
            embedding_dim=g.embedding_dim, embedding_layers=g.embedding_layers,
            freq_bands=g.freq_bands, msg_mode=g.msg_mode,
            msg_carrier_gain=g.msg_carrier_gain,
            film_carrier_gain=g.film_carrier_gain,
            film_gamma_bias=g.film_gamma_bias, **common)
        self.decoder = SEANetDecoder(
            n_filters=g.channels_dec, n_residual_layers=g.n_residual_dec,
            final_activation=g.final_activation, res_scale=g.res_scale_dec,
            **common)
        # fixed orthonormal per-bit latent directions (RandomState(18))
        rs = np.random.RandomState(18)
        c = np.linalg.qr(rs.randn(g.dimension, g.msg_dimension))[0].astype(np.float32)
        self.register_buffer("latent_carrier",
                             torch.from_numpy(np.ascontiguousarray(c.T)),
                             persistent=False)

    @property
    def hop_length(self) -> int:
        return self.config.hop_length

    def _latent_carrier(self, latent: torch.Tensor,
                        msg: torch.Tensor) -> torch.Tensor:
        """Add the per-bit latent directions, scaled by the latent's own RMS
        (no gradient through it). The conditioning math runs in f32."""
        s = 2.0 * msg.float() - 1.0
        rms = torch.sqrt(torch.mean(torch.square(latent.float()), dim=(1, 2),
                                    keepdim=True) + 1e-12).detach()
        off = (s @ self.latent_carrier)[:, :, None]  # [B, dim, 1]
        return latent + (self.config.latent_carrier_gain * rms * off).to(
            latent.dtype)

    def forward(self, audio: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        length = audio.shape[-1]
        right_pad = -length % self.hop_length
        if right_pad:
            audio = torch.nn.functional.pad(audio, (0, right_pad))
        latent = self.encoder(audio, msg)
        if self.config.latent_carrier_gain > 0 and msg is not None:
            latent = self._latent_carrier(latent, msg)
        return self.decoder(latent)[..., :length]
