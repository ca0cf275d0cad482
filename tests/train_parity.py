"""One training step of a tiny configuration in both packages, for the
parity tests of the configurations off the shipped one (the option
variants, the learned STFT basis): the port's ``train_step`` against the
JAX package's losses and gradients, built from its own functions in
``make_train_step``'s order (generator forward; the discriminator's
gradient at the initial discriminator on the detached residual, clipped,
and its AdamW update; the generator total's gradient against the updated
discriminator, the generator's clipped). Three JAX compiles: the
generator, the discriminator loss's gradient and the generator total's.

The zero-init gates (``res_scale_param``, ``scale_param``) and the norm
modules' zero biases are moved off zero in both packages before the step
(``tests/variants.py`` ``move_off_zero``): the gates so that the residual
branches they gate take part in the comparison, the biases so that no
output sits on a kink. (Under ``norm: layer_norm`` the generator's last
conv, one channel wide, makes the residual its norm's bias alone: exactly
zero at init, so that every L1 term of the generator loss sits at |0|,
where JAX's subgradient of a difference of two STFT paths depends on how
XLA fused them.)

Gradient leaves are held as ``tests/test_torch_train.py`` holds them (the
relative norm of port - JAX against ``GRAD_TOL``), with one floor: a leaf
whose JAX gradient is under 1e-6 of its network's gradient norm (the
option variants have such leaves, down to 1e-20 of it, where f32 resolves
nothing relative to the leaf) is measured against 1e-6 of that norm."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tests.test_torch_train import BANK, GRAD_TOL, KEY, export_grads
from tests.variants import move_off_zero
from tests.torch_jax_bridge import jax_draws, jax_params, tiny_configs
from waveverify_tpu.effects.effects import EffectBank as JBank
from waveverify_tpu.losses import decoding_loss as jdecoding_loss
from waveverify_tpu.losses import discriminator_loss as jdiscriminator_loss
from waveverify_tpu.losses import generator_loss as jgenerator_loss
from waveverify_tpu.losses import l1_loss as jl1_loss
from waveverify_tpu.losses import localization_loss as jlocalization_loss
from waveverify_tpu.losses import mel_spectrogram_loss as jmel_loss
from waveverify_tpu.losses import multi_scale_stft_loss as jstft_loss
from waveverify_tpu.train.state import clip_by_global_norm as jclip
from waveverify_tpu.train.state import make_optimizers
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_tpu.train.watermarking import forward_train as jforward_train
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.train.state import create_train_state
from waveverify_torch.train.step import train_step

B, T = 4, 3200
NETS = ("generator", "detector", "locator", "discriminator")
LEAF_FLOOR = 1e-6
__all__ = ["GRAD_TOL", "NETS", "noise_floor", "rel", "step_both", "worst_leaf"]


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _inputs():
    rng = np.random.RandomState(0)
    audio = (rng.randn(B, T) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (B, 16)).astype(np.float32)
    return audio, msg, np.array([0, 1, 2, 3], np.int32)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _port_state(tcfg):
    """The seed-0 state with the zero-init gates and norm biases moved off
    zero."""
    state = create_train_state(tcfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    move_off_zero(state.models)
    return state


def _port_step(tcfg, scale=1.0):
    state = _port_state(tcfg)
    audio, msg, idx = _inputs()
    tm = train_step(state, tcfg, EffectBank(BANK), torch.from_numpy(audio) * scale,
                    torch.from_numpy(msg), idx, jax_draws(KEY, 0, B, T, BANK))
    return state, tm


def noise_floor(configure, tm):
    """How far the port's gradient norms move when the audio is scaled by
    1 +- 1e-7: the f32 noise floor of the norms' comparison."""
    _, tcfg = (configure(c) for c in tiny_configs(B, remat=False))
    runs = [_port_step(tcfg, 1 + e)[1] for e in (1e-7, -1e-7)]
    return {f"grad_norm/{net}": max(rel(m[f"grad_norm/{net}"], tm[f"grad_norm/{net}"])
                                    for m in runs)
            for net in ("generator", "discriminator")}


def step_both(configure):
    """``configure`` maps each package's tiny TrainConfig to the one to
    step. Returns (port metrics, JAX values ``{"loss", "adv/disc_loss",
    "grad_norm/<net>"}``, the port's gradients and JAX's, each ``{net:
    {flax path: array}}``)."""
    jcfg, tcfg = (configure(c) for c in tiny_configs(B, remat=False))
    wm, disc = jax_params(_port_state(tcfg).models)
    state, tm = _port_step(tcfg)
    ours = {net: export_grads(getattr(state.models, net)) for net in NETS}
    audio, msg, idx = _inputs()

    jmodels = JModels.from_config(jcfg)
    lc = jcfg.loss
    assert lc.lambda_dec_clean == lc.lambda_dec_bits == lc.lambda_dec_lowband == 0
    a, m, i = map(jnp.asarray, (audio, msg, idx))
    k_fwd, k_gp = jax.random.split(jax.random.fold_in(KEY, 0))
    jbank = JBank(BANK)
    _, disc_tx = make_optimizers(jcfg.optim)
    fake = jax.jit(jmodels.apply_generator)(wm["generator"], a, m)

    def d_loss(dp):
        return jdiscriminator_loss(lambda x: jmodels.apply_discriminator(dp, x),
                                   fake, a, key=k_gp, gp_weight=lc.gp_weight)

    d_val, d_grads = jax.jit(jax.value_and_grad(d_loss))(disc)
    d_grads, d_norm = jclip(d_grads, 10.0)
    updates, _ = disc_tx.update(d_grads, disc_tx.init(disc), disc)
    new_disc = optax.apply_updates(disc, updates)

    def g_loss(wm_p):
        outs = jforward_train(jmodels, wm_p, k_fwd, a, m, i, jbank,
                              window_duration=jcfg.window_duration, remat=False)
        w = outs["watermarked"]
        adv, _ = jgenerator_loss(
            lambda x: jmodels.apply_discriminator(new_disc, x), w, a)
        return (lc.lambda_stft * jstft_loss(w, a, window_lengths=lc.stft_window_lengths)
                + lc.lambda_mel * jmel_loss(
                    w, a, n_mels=lc.mel_n_mels, window_lengths=lc.mel_window_lengths,
                    clamp_eps=lc.mel_clamp_eps, mag_weight=lc.mel_mag_weight,
                    pow=lc.mel_pow)
                + lc.lambda_waveform * jl1_loss(w, a)
                + lc.lambda_adv_gen * adv
                + lc.lambda_dec * jdecoding_loss(outs["detector_logits"],
                                                 outs["mask"], m)
                + lc.lambda_loc * jlocalization_loss(outs["locator_logits"],
                                                     outs["mask"]))

    g_val, wm_grads = jax.jit(jax.value_and_grad(g_loss))(wm)
    wm_grads = dict(wm_grads)
    wm_grads["generator"], g_norm = jclip(wm_grads["generator"], 10.0)
    ref = {net: _flatten(wm_grads[net]) for net in NETS[:3]}
    ref["discriminator"] = _flatten(d_grads)
    values = {"loss": g_val, "adv/disc_loss": d_val,
              "grad_norm/generator": g_norm, "grad_norm/discriminator": d_norm}
    return tm, values, ours, ref


def worst_leaf(ours, ref):
    """(path, relative norm of port - JAX) of the leaf that differs most,
    each leaf's norm floored at ``LEAF_FLOOR`` of the network's."""
    assert set(ours) == set(ref), sorted(set(ours) ^ set(ref))
    total = np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                        for r in ref.values()))
    dev = {k: float(np.linalg.norm(ours[k] - ref[k]))
           / max(float(np.linalg.norm(ref[k])), LEAF_FLOOR * total, 1e-30)
           for k in ref}
    worst = max(dev, key=dev.get)
    return worst, dev[worst]
