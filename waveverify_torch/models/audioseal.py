"""AudioSeal's generator and detector (``src/audioseal/models.py`` of
github.com/facebookresearch/audioseal), and a holder that serves them
through ``WaveVerify`` as :class:`WatermarkModels` serves WaveVerify's.

- :class:`MsgProcessor`: ``nn.Embedding(2 * nbits, dimension)`` indexed at
  ``2k + bit_k``, summed over k and added to every frame of the latent.
- :class:`AudioSealGenerator`: audio ``[B, 1, T]`` and bits -> the
  watermark ``[B, 1, T]`` (encoder, message, decoder, trimmed to T).
- :class:`AudioSealDetector`: audio ``[B, 1, T]`` -> logits ``[B, T, 2 +
  nbits]`` at the sample rate (encoder, a transposed conv with kernel and
  stride the hop, a 1x1 conv; the two as one product, ``fused_upsample_head``).
  Channels 0-1 go through a softmax, channel 1 being the presence
  probability; bit k is ``sigmoid(time-mean of logit 2 + k)``.

:func:`init_audioseal` draws weights with PyTorch's default initialisers of
the published modules.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from waveverify_torch.config import AudioSealConfig
from waveverify_torch.modules.audiocraft import SEANetDecoder, SEANetEncoder
from waveverify_torch.modules.conv import (
    NormConv1d,
    NormConvTranspose1d,
    fused_upsample_head,
)


def seanet_kwargs(cfg: AudioSealConfig) -> dict:
    """The keyword arguments the encoder and the decoder share."""
    if cfg.norm_params:
        raise NotImplementedError(f"norm_params {cfg.norm_params!r}: the published "
                                  "cards' {} only")
    return dict(channels=cfg.channels, dimension=cfg.dimension, n_filters=cfg.n_filters,
                n_residual_layers=cfg.n_residual_layers, ratios=tuple(cfg.ratios),
                activation=cfg.activation, activation_params=dict(cfg.activation_params),
                norm=cfg.norm, kernel_size=cfg.kernel_size,
                last_kernel_size=cfg.last_kernel_size,
                residual_kernel_size=cfg.residual_kernel_size,
                dilation_base=cfg.dilation_base, causal=cfg.causal, pad_mode=cfg.pad_mode,
                true_skip=cfg.true_skip, compress=cfg.compress, lstm=cfg.lstm,
                disable_norm_outer_blocks=cfg.disable_norm_outer_blocks)


class MsgProcessor(nn.Module):
    """Adds the message's embedding, ``sum_k E[2k + bit_k]``, to every frame."""

    def __init__(self, nbits: int, hidden_size: int):
        super().__init__()
        if nbits <= 0:
            raise ValueError("AudioSeal's message path needs nbits > 0")
        self.nbits = nbits
        self.msg_processor = nn.Embedding(2 * nbits, hidden_size)

    def forward(self, hidden: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        """hidden ``[B, H, T']``, msg ``[B, nbits]`` of {0, 1}."""
        idx = 2 * torch.arange(msg.shape[-1], device=msg.device) + msg.long()
        aux = self.msg_processor(idx).sum(dim=-2)  # [B, H]
        return hidden + aux.to(hidden.dtype)[:, :, None]


class AudioSealGenerator(nn.Module):
    """audio ``[B, 1, T]``, bits ``[B, nbits]`` -> watermark ``[B, 1, T]``."""

    def __init__(self, cfg: AudioSealConfig):
        super().__init__()
        kw = seanet_kwargs(cfg)
        self.encoder = SEANetEncoder(**kw)
        self.decoder = SEANetDecoder(
            **kw, final_activation=cfg.final_activation,
            final_activation_params=cfg.final_activation_params,
            trim_right_ratio=cfg.trim_right_ratio)
        self.msg_processor = MsgProcessor(cfg.nbits, cfg.dimension)

    def forward(self, audio: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        hidden = self.msg_processor(self.encoder(audio), msg)
        return self.decoder(hidden)[..., :audio.shape[-1]]


class AudioSealDetector(nn.Module):
    """audio ``[B, 1, T]`` -> logits ``[B, T, 2 + nbits]`` (time-major, as
    the port's detectors give theirs)."""

    def __init__(self, cfg: AudioSealConfig):
        super().__init__()
        hop = cfg.hop_length
        self.encoder = SEANetEncoder(**seanet_kwargs(cfg))
        self.reverse_convolution = NormConvTranspose1d(
            cfg.dimension, cfg.output_dim, hop, stride=hop, norm="none", use_bias=True)
        self.last_layer = NormConv1d(cfg.output_dim, 2 + cfg.nbits, 1, norm="none",
                                     use_bias=True)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return fused_upsample_head(self.reverse_convolution, self.last_layer,
                                   self.encoder(audio), audio.shape[-1])


def decide(logits: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """AudioSeal's decisions from logits ``[B, T, 2 + nbits]`` over their
    first ``t`` samples: (bit probabilities ``[B, nbits]``, each
    ``sigmoid`` of its logit's mean; the detection score ``[B]``, the share
    of samples whose presence probability exceeds 0.5, as AudioSeal's
    ``detect_watermark``)."""
    valid = torch.arange(logits.shape[1], device=logits.device) < t
    n = max(t, 1)
    presence = torch.softmax(logits[..., :2], dim=-1)[..., 1]
    score = torch.sum((presence > 0.5) & valid, dim=1) / n
    probs = torch.sigmoid(torch.sum(logits[..., 2:] * valid[None, :, None], dim=1) / n)
    return probs, score


class AudioSealModels(nn.Module):
    """AudioSeal's generator and detector behind ``WatermarkModels``'
    interface. The detector gives the presence too, so it is also the
    locator."""

    # not causal, and recurrent over the whole input: serving runs every
    # input whole at its own length, as AudioSeal does
    whole_input = True
    decide = staticmethod(decide)

    def __init__(self, cfg: AudioSealConfig):
        super().__init__()
        self.config = cfg
        self.generator = AudioSealGenerator(cfg)
        self.detector = AudioSealDetector(cfg)

    def apply_generator(self, audio: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]`` -> the residual ``alpha * watermark`` ``[B, T]``."""
        wm = self.generator(audio[:, None, :], msg)[:, 0, :]
        return wm if self.config.alpha == 1.0 else wm * self.config.alpha

    def apply_detector(self, audio: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]`` -> logits ``[B, T, 2 + nbits]``."""
        return self.detector(audio[:, None, :])

    def apply_locator(self, audio: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]`` -> the presence channel's log-odds ``[B, T]``
        (logit 1 - logit 0), whose sigmoid is the softmax's channel 1."""
        logits = self.apply_detector(audio)
        return logits[..., 1] - logits[..., 0]


def _uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)


def init_audioseal(root: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter under ``root`` from ``generator`` (a CPU
    ``torch.Generator``), in module order, by PyTorch's default
    initialisers of the modules AudioSeal is built from: a conv's weight
    and bias uniform in +-1/sqrt(fan_in) (``kaiming_uniform_(a=sqrt(5))``;
    a transposed conv's fan from its weight's dims 1 and 2, as torch's), a
    weight norm's gain ``||v||`` (so the kernel is ``v``), an LSTM's
    tensors uniform in +-1/sqrt(hidden), an embedding N(0, 1)."""
    with torch.no_grad():
        for m in root.modules():
            if isinstance(m, (NormConv1d, NormConvTranspose1d)):
                bound = 1.0 / math.sqrt(math.prod(m.v.shape[1:]))
                _uniform_(m.v, bound, generator)
                if m.g is not None:
                    m.g.copy_(torch.sqrt(torch.sum(m.v * m.v, dim=m._norm_dims())))
                if m.b is not None:
                    _uniform_(m.b, bound, generator)
            elif isinstance(m, nn.LSTM):
                for p in m.parameters():
                    _uniform_(p, 1.0 / math.sqrt(m.hidden_size), generator)
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
