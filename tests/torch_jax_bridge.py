"""Shared pieces of the training parity tests: one tiny configuration in
both packages, parameters carried from the port to a JAX tree, and the
JAX package's key chain turned into the port's :class:`Draws` and into
each random effect's draws."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from waveverify_tpu import config as jcfg
from waveverify_torch import config as tcfg
from waveverify_torch.effects.effects import RANDOM_EFFECTS
from waveverify_torch.train.watermarking import Draws
from waveverify_torch.weights import export_params

SMALL = dict(dimension=32, channels_enc=8, kernel_size=5, last_kernel_size=5,
             residual_kernel_size=5, dilation_base=1, skip="identity",
             causal=True, encoder_l2norm=True, bias=True,
             spec_compression="log", zero_init=False)
SECTIONS = dict(
    generator=("GeneratorConfig", dict(channels_dec=12, n_residual_enc=1,
                                       n_residual_dec=1, **SMALL)),
    detector=("DetectorConfig", dict(n_residual_enc=1, output_dim=8, **SMALL)),
    locator=("LocatorConfig", dict(n_residual_enc=1, output_dim=8, **SMALL)),
    discriminator=("DiscriminatorConfig", dict(periods=(2,), fft_sizes=(256,))),
    loss=("LossConfig", dict(stft_window_lengths=(256,), mel_n_mels=(5, 10),
                             mel_window_lengths=(128, 256))),
)
NETS = ("generator", "detector", "locator")


def tiny_configs(batch_size: int = 4, **top):
    """(JAX TrainConfig, port TrainConfig) of one tiny configuration."""
    out = []
    for mod in (jcfg, tcfg):
        sections = {k: getattr(mod, cls)(**kw) for k, (cls, kw) in SECTIONS.items()}
        out.append(mod.TrainConfig(batch_size=batch_size, **sections, **top))
    return tuple(out)


def unflatten(flat):
    """'/'-joined flat dict -> nested dict of jnp arrays."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def jax_params(models):
    """(wm_params, disc_params) JAX trees holding the port's parameters."""
    wm = {net: unflatten(export_params(getattr(models, net), "x"))["x"]
          for net in NETS}
    disc = unflatten(export_params(models.discriminator, "x"))["x"]
    return wm, disc


def jax_draws(key, step, b, t, bank_specs, sample_rate=16000,
              window_duration=0.1, jitter_hop=0):
    """The draws of JAX ``make_train_step``'s step ``step`` under ``key``,
    as the port's Draws (the key chain of step.py and watermarking.py);
    ``bank_specs`` is the bank's (name, params) list."""
    k_fwd, k_gp = jax.random.split(jax.random.fold_in(key, step))
    k_loc, k_seq, k_fx, k_jit, k_jit_clean = jax.random.split(k_fwd, 5)
    scores, probs, offset = jax_localization_draws(k_loc, b, t, sample_rate,
                                                   window_duration)
    u, shift, perm = jax_sequence_draws(k_seq, t, sample_rate)
    fx = jax_bank_draws(k_fx, bank_specs, b, t)
    jitter = jitter_clean = None
    if jitter_hop > 0:
        jitter = to_torch(jax.random.randint(k_jit, (b,), 0, jitter_hop))
        jitter_clean = to_torch(jax.random.randint(k_jit_clean, (b,), 0, jitter_hop))
    alpha = jax.random.uniform(k_gp, (b, 1))[:, 0]
    return Draws(scores, probs, offset, u, shift, perm, fx, jitter,
                 jitter_clean, to_torch(alpha))


def jax_bank_draws(key, bank_specs, b, t):
    """The draws of each random branch of the JAX "stack" bank under
    ``key``: branch i's key is ``split(key, n_branches)[i]``."""
    keys = jax.random.split(key, len(bank_specs))
    return [jax_effect_draws(name, params, keys[i], b, t)
            for i, (name, params) in enumerate(bank_specs)
            if name in RANDOM_EFFECTS]


def jax_val_draws(key, eval_effects, b, t, sample_rate=16000,
                  window_duration=0.1):
    """The draws of JAX ``forward_valid`` under ``key``: localization,
    sequence, then one key per effect of the sweep."""
    k_loc, k_seq, k = jax.random.split(key, 3)
    fx = []
    for name, params in eval_effects:
        k, sub = jax.random.split(k)
        if name in RANDOM_EFFECTS:
            fx.append(jax_effect_draws(name, params, sub, b, t))
    return Draws(*jax_localization_draws(k_loc, b, t, sample_rate,
                                         window_duration),
                 *jax_sequence_draws(k_seq, t, sample_rate), fx)


def jax_effect_draws(name, params, key, b, t):
    """What JAX ``AudioEffects.<name>`` draws from ``key`` on ``[b, t]``
    audio, as the keyword arguments the port's effect takes
    (waveverify_tpu/effects/effects.py: each effect's own key splits)."""
    if name in ("random_noise", "white_noise"):
        return {"noise": to_torch(jax.random.normal(key, (b, t)))}
    if name == "sample_suppression":
        return {"u": to_torch(jax.random.uniform(key, (b, t)))}
    if name == "pink_noise":
        rows = []
        for d in range(params.get("depth", 16)):
            key, sub = jax.random.split(key)
            rows.append(to_torch(jax.random.normal(sub, (b, -(-t // (1 << d))))))
        return {"rows": rows}
    if name == "random_equalization":
        lo, hi = params.get("freq_range", (200.0, 4000.0))
        g_lo, g_hi = params.get("gain_range", (-6.0, 6.0))
        kf, kg = jax.random.split(key)
        return {"log_freq": to_torch(jax.random.uniform(
                    kf, (), minval=math.log(lo), maxval=math.log(hi))),
                "gain_db": to_torch(jax.random.uniform(
                    kg, (), minval=g_lo, maxval=g_hi))}
    if name == "echo":
        v_lo, v_hi = params.get("volume_range", (0.1, 0.5))
        d_lo, d_hi = params.get("duration_range", (0.1, 0.5))
        kd, kv = jax.random.split(key)
        return {"duration": to_torch(jax.random.uniform(
                    kd, (), minval=d_lo, maxval=d_hi)),
                "volume": to_torch(jax.random.uniform(
                    kv, (), minval=v_lo, maxval=v_hi))}
    raise ValueError(f"{name} draws nothing")


def jax_localization_draws(k_loc, b, t, sample_rate=16000, window_duration=0.1):
    """(scores, probs, offset) of ``localization_augmentation(k_loc, ...)``."""
    k_sel, k_act, k_other = jax.random.split(k_loc, 3)
    n_segs = -(-t // int(window_duration * sample_rate))
    return (to_torch(jax.random.uniform(k_sel, (b, n_segs))),
            to_torch(jax.random.uniform(k_act, (b, n_segs))),
            to_torch(jax.random.randint(k_other, (b, n_segs), 1, max(b, 2))))


def jax_sequence_draws(k_seq, t, sample_rate=16000):
    """(u, shift, perm) of ``sequence_augmentation(k_seq, ...)``."""
    k_method, k_shift, k_perm = jax.random.split(k_seq, 3)
    seg = int(0.5 * sample_rate)
    n_segs = t // seg if t >= 2 * seg and t % seg == 0 else 1
    return (float(jax.random.uniform(k_method, ())),
            int(jax.random.randint(k_shift, (), 1, t)),
            to_torch(jax.random.permutation(k_perm, n_segs)))


def to_torch(x):
    """A JAX or numpy array as a torch tensor (integers as int64)."""
    a = np.array(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)
