"""Model configuration for the PyTorch port.

A copy of the generator, detector and locator sections of
``waveverify_tpu/config.py`` (the JAX package is not imported), and
:func:`apply_model_config`, which overlays the architecture snapshot a
``.npz`` checkpoint carries under ``__config__``. The serving path reads its
config from that snapshot alone, so no YAML reader is needed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class GeneratorConfig:
    """FiLM-conditioned SEANet generator (conf/base.yml ``Generator``)."""

    sample_rate: int = 16000
    channels_audio: int = 1
    dimension: int = 128
    msg_dimension: int = 16
    channels_enc: int = 64
    channels_dec: int = 96
    n_fft_base: int = 64
    n_residual_enc: int = 2
    n_residual_dec: int = 3
    res_scale_enc: float = 0.5773502691896258
    res_scale_dec: float = 0.5773502691896258
    strides: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_alpha: float = 1.0
    norm: str = "weight_norm"
    kernel_size: int = 5
    last_kernel_size: int = 5
    residual_kernel_size: int = 5
    dilation_base: int = 1
    skip: str = "identity"
    final_activation: Optional[str] = "Tanh"
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    encoder_l2norm: bool = True
    bias: bool = False
    spec: str = "stft"
    spec_layer: str = "1x1_zero"
    spec_compression: str = "log"
    # accepted but never forwarded to the encoder, as in the reference
    spec_learnable: bool = True
    spec_learnable_effective: bool = False
    film_gamma_bias: float = 0.0
    msg_mode: str = "reference"
    msg_carrier_gain: float = 1.0
    film_carrier_gain: float = 0.0
    latent_carrier_gain: float = 0.0
    pad_mode: str = "constant"
    causal: bool = True
    zero_init: bool = False
    inout_norm: bool = True
    nbits: int = 16
    embedding_dim: int = 64
    embedding_layers: int = 2
    freq_bands: int = 4

    @property
    def hop_length(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out


@dataclass(frozen=True)
class DetectorConfig:
    """SEANet encoder + upsampling bit head (conf/base.yml ``Detector``)."""

    sample_rate: int = 16000
    channels_audio: int = 1
    dimension: int = 128
    channels_enc: int = 64
    n_fft_base: int = 64
    n_residual_enc: int = 2
    res_scale_enc: float = 0.5773502691896258
    strides: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_alpha: float = 1.0
    norm: str = "weight_norm"
    kernel_size: int = 5
    last_kernel_size: int = 5
    residual_kernel_size: int = 5
    dilation_base: int = 1
    skip: str = "identity"
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    encoder_l2norm: bool = True
    bias: bool = False
    spec: str = "stft"
    spec_compression: str = "log"
    pad_mode: str = "constant"
    causal: bool = True
    zero_init: bool = False
    inout_norm: bool = True
    output_dim: int = 32
    nbits: int = 16

    @property
    def hop_length(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out


@dataclass(frozen=True)
class LocatorConfig:
    """Small SEANet encoder + presence-mask head (conf/base.yml
    ``Locator``)."""

    sample_rate: int = 16000
    channels_audio: int = 1
    dimension: int = 64
    channels_enc: int = 32
    n_fft_base: int = 64
    n_residual_enc: int = 1
    res_scale_enc: float = 0.5773502691896258
    strides: Tuple[int, ...] = (8, 4)
    activation: str = "ELU"
    activation_alpha: float = 1.0
    norm: str = "weight_norm"
    kernel_size: int = 5
    last_kernel_size: int = 5
    residual_kernel_size: int = 5
    dilation_base: int = 1
    skip: str = "identity"
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    encoder_l2norm: bool = True
    bias: bool = False
    spec: str = "stft"
    spec_compression: str = "log"
    pad_mode: str = "constant"
    causal: bool = True
    zero_init: bool = False
    inout_norm: bool = True
    output_dim: int = 32
    nbits: int = 16

    @property
    def hop_length(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out


@dataclass(frozen=True)
class TrainConfig:
    """The model sections of the JAX package's ``TrainConfig``."""

    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    locator: LocatorConfig = field(default_factory=LocatorConfig)


def _build(cls, section: Dict[str, Any]):
    valid = {f.name for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in section.items():
        if key not in valid:
            continue
        if isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        kwargs[key] = value
    return cls(**kwargs)


def apply_model_config(cfg: TrainConfig, snap: Dict[str, Any]) -> TrainConfig:
    """Overlay a checkpoint's model-config snapshot onto ``cfg``."""
    out = cfg
    if snap.get("Generator"):
        out = dataclasses.replace(
            out, generator=_build(GeneratorConfig, snap["Generator"]))
    if snap.get("Detector"):
        out = dataclasses.replace(
            out, detector=_build(DetectorConfig, snap["Detector"]))
    if snap.get("Locator"):
        out = dataclasses.replace(
            out, locator=_build(LocatorConfig, snap["Locator"]))
    return out

