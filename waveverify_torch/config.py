"""Configuration of the PyTorch port.

A copy of ``waveverify_tpu/config.py`` (the JAX package is not imported):
frozen dataclasses whose defaults equal ``conf/base.yml``;
:func:`apply_model_config`, which overlays the architecture snapshot a
``.npz`` checkpoint carries under ``__config__`` (all the serving path
reads); and :func:`load_config` for the trainer's YAML files, which imports
PyYAML only when a file is read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union


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
class DiscriminatorConfig:
    """MPD periods, MSD rates and MRD FFT sizes (conf/base.yml
    ``Discriminator``)."""

    sample_rate: int = 16000
    rates: Tuple[int, ...] = ()
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    fft_sizes: Tuple[int, ...] = (2048, 1024, 512)
    bands: Tuple[Tuple[float, float], ...] = (
        (0.0, 0.1),
        (0.1, 0.25),
        (0.25, 0.5),
        (0.5, 0.75),
        (0.75, 1.0),
    )


@dataclass(frozen=True)
class LossConfig:
    """Loss weights and spectral-loss settings (conf/base.yml ``lambdas``,
    ``MultiScaleSTFTLoss``, ``MelSpectrogramLoss``).

    The ``warmup_*`` knobs drive the trainer's host controllers
    (``train/loop.py``: the BER-gated ramp, the nbits curriculum,
    alternation, the discriminator's cadence and the message freeze);
    ``warmup_steps`` alone is the step-indexed ramp. ``lambda_dec_clean`` adds a decoding loss on the clean
    watermarked audio, ``lambda_dec_bits`` a BCE on the masked time-mean
    logit, ``lambda_dec_lowband`` the same pair on a lowpassed copy."""

    lambda_waveform: float = 1000.0
    lambda_mel: float = 20.0
    lambda_stft: float = 10.0
    lambda_adv_gen: float = 40.0
    lambda_loc: float = 100.0
    lambda_dec: float = 10000.0
    stft_window_lengths: Tuple[int, ...] = (2048, 512)
    mel_n_mels: Tuple[int, ...] = (5, 10, 20, 40, 80, 160, 320)
    mel_window_lengths: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048)
    mel_pow: float = 1.0
    mel_clamp_eps: float = 1e-5
    mel_mag_weight: float = 0.0
    gp_weight: float = 10.0
    warmup_steps: int = 0
    warmup_init_scale: float = 0.01
    warmup_ber_gate: float = 0.0
    warmup_disc_every: int = 1
    warmup_alt_period: int = 0
    warmup_alt_gen_frac: float = 0.25
    warmup_msg_freeze_gate: float = 0.0
    warmup_msg_refreeze: bool = False
    warmup_nbits_start: int = 0
    warmup_nbits_gate: float = 0.02
    warmup_fx_gate: float = 0.0
    lambda_dec_clean: float = 0.0
    lambda_dec_bits: float = 0.0
    lambda_dec_lowband: float = 0.0
    lowband_cutoff_hz: float = 2000.0


@dataclass(frozen=True)
class OptimConfig:
    """AdamW and its exponential decay (conf/base.yml ``AdamW``,
    ``ExponentialLR``). ``detector_lr_mult`` and ``generator_lr_mult``
    scale those subtrees' learning rate; ``decay_exclude_msg_path`` exempts
    the message MLP and FiLM readouts (``msg_*``, ``film_*``) from weight
    decay."""

    lr: float = 1e-4
    beta1: float = 0.8
    beta2: float = 0.99
    exp_gamma: float = 0.999996
    max_grad_norm: float = 10.0
    detector_lr_mult: float = 1.0
    generator_lr_mult: float = 1.0
    decay_exclude_msg_path: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """The whole training configuration; its defaults equal
    ``conf/base.yml``.

    ``remat`` recomputes the three networks' forward (and the
    augment-and-attack segment) in the backward pass instead of keeping
    their activations; ``sub_hop_jitter`` rolls every detector and locator
    input by a per-sample 0..hop-1 samples."""

    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    locator: LocatorConfig = field(default_factory=LocatorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    batch_size: int = 32
    val_batch_size: int = 16
    num_iters: int = 600000
    valid_freq: int = 1000
    sample_freq: int = 10000
    seed: int = 0
    train_duration: float = 1.0
    val_duration: float = 5.0
    window_duration: float = 0.1
    k_windows: int = 5
    remat: bool = True
    sub_hop_jitter: bool = False


@dataclass(frozen=True)
class AudioSealConfig:
    """AudioSeal (San Roman et al., ICML 2024): audiocraft's SEANet with an
    LSTM bottleneck, a summed message embedding and a detector head at the
    sample rate. The fields are the model cards' ``seanet`` keys under
    their card names (``src/audioseal/cards/audioseal_wm_16bits.yaml`` and
    ``audioseal_detector_16bits.yaml``), the decoder's and the detector's
    sections, ``nbits``, and the rate and ``alpha`` AudioSeal embeds at;
    the defaults are the 16-bit cards'."""

    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_params: Dict[str, float] = field(default_factory=lambda: {"alpha": 1.0})
    norm: str = "weight_norm"
    norm_params: Dict[str, Any] = field(default_factory=dict)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    causal: bool = False
    pad_mode: str = "constant"
    true_skip: bool = True
    compress: int = 2
    lstm: int = 2
    disable_norm_outer_blocks: int = 0
    # the generator card's ``decoder`` section
    final_activation: Optional[str] = None
    final_activation_params: Optional[Dict[str, float]] = None
    trim_right_ratio: float = 1.0
    nbits: int = 16
    # the detector card's ``detector`` section
    output_dim: int = 32
    sample_rate: int = 16000
    alpha: float = 1.0

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out

    @classmethod
    def from_card(cls, *cards: Dict[str, Any]) -> "AudioSealConfig":
        """A config from one or more dicts of a model card's layout
        (``seanet``, ``decoder``, ``detector``, ``nbits``; ``sample_rate``
        and ``alpha`` where given): the generator's card and the
        detector's may be passed together, and must then agree on their
        ``seanet`` section and ``nbits``."""
        valid = {f.name for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for card in cards:
            parts = dict(card.get("seanet", {}))
            for section in ("decoder", "detector"):
                parts.update(card.get(section) or {})
            parts.update({k: card[k] for k in ("nbits", "sample_rate", "alpha")
                          if k in card})
            for key, value in parts.items():
                if key not in valid:
                    continue
                if isinstance(value, list):
                    value = tuple(value)
                if key in kwargs and kwargs[key] != value:
                    raise ValueError(f"the cards disagree on {key}: "
                                     f"{kwargs[key]!r} and {value!r}")
                kwargs[key] = value
        return cls(**kwargs)


@dataclass(frozen=True)
class WavMarkConfig:
    """WavMark (Chen et al., arXiv:2308.12770; github.com/wavmark/wavmark):
    an invertible network of coupling blocks over the STFT of 1 s segments.
    The defaults are the released model's, ``wavmark.load_model()``'s
    ``Model(16000, num_bit=32, n_fft=1000, hop_length=400, num_layers=8)``
    with HiNet's blocks (``clamp`` 2.0, dense subnets of growth 32, LeakyReLU
    slope 0.01). The 32 bits are ``pattern`` (16 fixed bits that mark a
    segment as watermarked) followed by the 16-bit payload. ``pattern`` is
    the port's own: the published ``fix_pattern`` could not be checked."""

    sample_rate: int = 16000
    segment: int = 16000
    n_fft: int = 1000
    hop_length: int = 400
    num_layers: int = 8
    clamp: float = 2.0
    growth: int = 32
    slope: float = 0.01
    pattern: Tuple[int, ...] = (1, 1, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 1)
    payload_bits: int = 16

    @property
    def num_bits(self) -> int:
        return len(self.pattern) + self.payload_bits


def _build(cls, section: Dict[str, Any]):
    valid = {f.name for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in section.items():
        if key == "activation_kwargs" and isinstance(value, dict):
            if "alpha" in value and "activation_alpha" in valid:
                kwargs["activation_alpha"] = float(value["alpha"])
            continue
        if key not in valid:
            continue
        if isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        kwargs[key] = value
    return cls(**kwargs)


def _extract_section(raw: Dict[str, Any], name: str) -> Dict[str, Any]:
    """Collect nested ``name: {...}`` plus flat ``name.key:`` entries."""
    out: Dict[str, Any] = {}
    nested = raw.get(name)
    if isinstance(nested, dict):
        out.update(nested)
    prefix = name + "."
    for key, value in raw.items():
        if isinstance(key, str) and key.startswith(prefix):
            out[key[len(prefix):]] = value
    return out


def model_config_dict(cfg: TrainConfig) -> Dict[str, Any]:
    """JSON-able snapshot of the model sections, the ``__config__`` of a
    weights file."""
    return {
        "Generator": dataclasses.asdict(cfg.generator),
        "Detector": dataclasses.asdict(cfg.detector),
        "Locator": dataclasses.asdict(cfg.locator),
    }


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



_LAMBDAS = {
    "waveform/loss": "lambda_waveform",
    "mel/loss": "lambda_mel",
    "stft/loss": "lambda_stft",
    "adv/gen_loss": "lambda_adv_gen",
    "loc/loss": "lambda_loc",
    "dec/loss": "lambda_dec",
    "dec/loss_clean": "lambda_dec_clean",
    "dec/loss_bits": "lambda_dec_bits",
    "dec/loss_lowband": "lambda_dec_lowband",
}
# warmup section key -> (LossConfig field, type)
_WARMUP = {
    "steps": ("warmup_steps", int),
    "init_scale": ("warmup_init_scale", float),
    "ber_gate": ("warmup_ber_gate", float),
    "disc_every": ("warmup_disc_every", int),
    "fx_gate": ("warmup_fx_gate", float),
    "alt_period": ("warmup_alt_period", int),
    "alt_gen_frac": ("warmup_alt_gen_frac", float),
    "msg_freeze_gate": ("warmup_msg_freeze_gate", float),
    "msg_refreeze": ("warmup_msg_refreeze", bool),
    "nbits_start": ("warmup_nbits_start", int),
    "nbits_gate": ("warmup_nbits_gate", float),
}
_TOP_LEVEL = ("batch_size", "val_batch_size", "num_iters", "valid_freq",
              "sample_freq", "seed", "train_duration", "val_duration",
              "remat", "sub_hop_jitter")


def load_config(path: Union[str, Path, None] = None,
                overrides: Optional[Dict[str, Any]] = None) -> TrainConfig:
    """A TrainConfig from a file of the ``conf/base.yml`` schema (nested
    sections and flat ``Section.key`` entries), plus ``overrides`` in the
    same keys; defaults where neither says. PyYAML is imported only when a
    file is read: the port runs without it."""
    raw: Dict[str, Any] = {}
    if path is not None:
        try:
            import yaml
        except ImportError as exc:
            raise ImportError(f"reading {path} needs PyYAML, which is not "
                              "installed; build the TrainConfig in Python "
                              "instead") from exc
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if overrides:
        raw.update(overrides)

    loss: Dict[str, Any] = {}
    for k, v in _extract_section(raw, "lambdas").items():
        if k in _LAMBDAS:
            loss[_LAMBDAS[k]] = float(v)
    msl = _extract_section(raw, "MultiScaleSTFTLoss")
    if "window_lengths" in msl:
        loss["stft_window_lengths"] = tuple(msl["window_lengths"])
    mel = _extract_section(raw, "MelSpectrogramLoss")
    if "n_mels" in mel:
        loss["mel_n_mels"] = tuple(mel["n_mels"])
    if "window_lengths" in mel:
        loss["mel_window_lengths"] = tuple(mel["window_lengths"])
    for key, name in (("pow", "mel_pow"), ("clamp_eps", "mel_clamp_eps"),
                      ("mag_weight", "mel_mag_weight")):
        if key in mel:
            loss[name] = float(mel[key])
    for k, v in _extract_section(raw, "warmup").items():
        if k in _WARMUP:
            name, typ = _WARMUP[k]
            loss[name] = typ(v)
    if "lowband_cutoff_hz" in raw:
        loss["lowband_cutoff_hz"] = float(raw["lowband_cutoff_hz"])

    adamw = _extract_section(raw, "AdamW")
    explr = _extract_section(raw, "ExponentialLR")
    optim: Dict[str, Any] = {}
    if "lr" in adamw:
        optim["lr"] = float(adamw["lr"])
    if "betas" in adamw:
        optim["beta1"] = float(adamw["betas"][0])
        optim["beta2"] = float(adamw["betas"][1])
    if "gamma" in explr:
        optim["exp_gamma"] = float(explr["gamma"])
    for key in ("detector_lr_mult", "generator_lr_mult"):
        if key in adamw:
            optim[key] = float(adamw[key])

    return TrainConfig(
        generator=_build(GeneratorConfig, _extract_section(raw, "Generator")),
        detector=_build(DetectorConfig, _extract_section(raw, "Detector")),
        locator=_build(LocatorConfig, _extract_section(raw, "Locator")),
        discriminator=_build(DiscriminatorConfig,
                             _extract_section(raw, "Discriminator")),
        loss=LossConfig(**loss),
        optim=OptimConfig(**optim),
        **{k: raw[k] for k in _TOP_LEVEL if k in raw},
    )
