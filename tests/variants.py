"""Three configurations off the shipped one that reach the SEANet and conv
options no shipped config uses, numpy only (it imports neither JAX nor
either package, so ``chip_smoke.py`` uses it on the card too).

Each variant is a dict of per-network field overrides (the dataclass field
names both packages' ``GeneratorConfig`` / ``DetectorConfig`` /
``LocatorConfig`` share), laid over a configuration with :func:`apply`:

- ``wide_skips``: 1x1 skips, the zero-init residual and spec gates, an
  activation after each 1x1, LeakyReLU, weight standardization, centred
  reflect padding, a power-0.3 spectrogram and (generator) a learned STFT
  basis. No chain runs the fused kernel.
- ``grouped``: a learned skip scale of each kind, grouped convs
  (generator ``expansion`` 2, detector ``groups`` 8), a norm of each kind
  after or inside the convs, GELU / ReLU / Sigmoid, replicate padding and
  dilation base 2. No chain runs the fused kernel.
- ``kernel_alpha``: the shipped configuration with no weight norm and ELU
  alpha 0.5, so the generator's and locator's chains run the kernel with
  w = v and alpha 0.5; the detector's ``scale`` skip sends its chains to
  the plain path in the same program.
"""

import dataclasses

import numpy as np

NETS = ("generator", "detector", "locator")
GATES = ("res_scale_param", "scale_param")

VARIANTS = {
    "wide_skips": {
        net: dict(skip="1x1", zero_init=True, act_all=True,
                  activation="LeakyReLU", norm="weight_standardization",
                  causal=False, pad_mode="reflect", spec_compression="0.3",
                  **({"spec_learnable_effective": True}
                     if net == "generator" else {}))
        for net in NETS
    },
    "grouped": {
        "generator": dict(skip="channelwise_scale", expansion=2,
                          norm="layer_norm", activation="GELU",
                          pad_mode="replicate", dilation_base=2),
        "detector": dict(skip="exp_scale", groups=8, norm="spectral_norm",
                         activation="ReLU", pad_mode="replicate",
                         dilation_base=2),
        "locator": dict(skip="scale", norm="time_group_norm",
                        activation="Sigmoid", pad_mode="replicate",
                        dilation_base=2),
    },
    "kernel_alpha": {
        "generator": dict(norm="none", activation_alpha=0.5),
        "detector": dict(norm="none", activation_alpha=0.5, skip="scale"),
        "locator": dict(norm="none", activation_alpha=0.5),
    },
}

# which networks' chains the JAX gate sends to the fused kernel
KERNEL_NETS = {"wide_skips": (), "grouped": (),
               "kernel_alpha": ("generator", "locator")}


def apply(cfg, name: str):
    """``cfg`` (either package's TrainConfig) with variant ``name``'s
    overrides laid over its generator, detector and locator."""
    return dataclasses.replace(cfg, **{
        net: dataclasses.replace(getattr(cfg, net), **VARIANTS[name][net])
        for net in NETS})


def move_off_zero(models, seed: int = 1) -> None:
    """Move the zero-init gates (``res_scale_param``, ``scale_param``) of
    the port's ``models`` to 0.5 +- 0.1 and its norm modules' zero biases to
    +- 0.1, in place, from ``RandomState(seed)`` in parameter order.

    At random init the gates switch the residual branches off. Under
    ``wide_skips`` the generator's residual is then far below the audio's
    f32 resolution (rms 1.7e-11 at conf/base.yml width on 0.1-rms noise;
    2.3e-06 after this move), so ``audio + residual`` rounds differently
    per device; under ``grouped`` it is exactly zero (a layer norm over the
    last conv's one channel leaves its bias, zero at init). Either way the
    L1 losses sit on rounding or on a kink, so a step compared across
    devices or packages starts from these values instead."""
    rng = np.random.RandomState(seed)
    for name, p in models.named_parameters():
        leaf = name.split(".")[-1]
        if leaf in GATES:
            values = 0.5 + 0.1 * rng.randn(*p.shape)
        elif ".norm." in name and leaf == "bias":
            values = 0.1 * rng.randn(*p.shape)
        else:
            continue
        p.detach().copy_(p.new_tensor(values.astype(np.float32)))
