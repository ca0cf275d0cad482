"""Every gradient leaf of the port's split step (``disc_step``, then
``train_step(update_disc=False)``) against ``jax.grad`` of the losses the
JAX package's split programs differentiate (``make_disc_step``, then
``make_train_step(update_disc=False)``), f32 on the CPU at the tiny
configuration, ungated and under two gate settings, within
``test_torch_train.py``'s ``GRAD_TOL``. The split step's losses and
parameters are held to JAX's programs in ``test_torch_split_disc.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_split_disc import B, GATES, NEUTRAL, _fresh, _port_split
from tests.test_torch_train import (
    BANK,
    GRAD_TOL,
    KEY,
    NETS,
    _flatten,
    _inputs,
    export_grads,
)
from tests.torch_jax_bridge import jax_params, tiny_configs
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

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_steps():
    """The port's split step under each gate, from the seed-0 state."""
    _, tcfg = tiny_configs(B, remat=False)
    audio, msg, idx = _inputs()
    return {name: _port_split(tcfg, gate, audio, msg, idx)[0]
            for name, gate in GATES.items()}


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's gradients of each split step's two losses, leaf by leaf, as
    its two programs take them: the discriminator loss at the initial
    discriminator on ``apply_generator``'s output; the gated generator
    total against the discriminator the disc program updated (or the
    initial one when it did not run): ``make_disc_step``'s update, taken
    here from the same gradient. One compile for all gates."""
    jcfg, tcfg = tiny_configs(B, remat=False)
    jmodels = JModels.from_config(jcfg)
    wm, disc = jax_params(_fresh(tcfg).models)
    _, disc_tx = make_optimizers(jcfg.optim)
    lc = jcfg.loss
    audio, msg, idx = map(jnp.asarray, _inputs())
    k_fwd, k_gp = jax.random.split(jax.random.fold_in(KEY, 0))
    jbank = JBank(BANK)

    def d_loss(dp):
        fake = jmodels.apply_generator(wm["generator"], audio, msg)
        return jdiscriminator_loss(lambda x: jmodels.apply_discriminator(dp, x),
                                   fake, audio, key=k_gp, gp_weight=lc.gp_weight)

    def g_loss(wm, dp, percep, adv_on, mask):
        outs = jforward_train(jmodels, wm, k_fwd, audio, msg, idx, jbank,
                              window_duration=jcfg.window_duration, remat=False)
        w = outs["watermarked"]
        adv = jax.lax.cond(adv_on, lambda w_: jgenerator_loss(
            lambda x: jmodels.apply_discriminator(dp, x), w_, audio)[0],
            lambda w_: jnp.float32(0.0), w)
        return (percep * (lc.lambda_stft * jstft_loss(
                    w, audio, window_lengths=lc.stft_window_lengths)
                + lc.lambda_mel * jmel_loss(
                    w, audio, n_mels=lc.mel_n_mels,
                    window_lengths=lc.mel_window_lengths,
                    clamp_eps=lc.mel_clamp_eps, mag_weight=lc.mel_mag_weight,
                    pow=lc.mel_pow)
                + lc.lambda_waveform * jl1_loss(w, audio)
                + lc.lambda_adv_gen * adv)
                + lc.lambda_dec * jdecoding_loss(outs["detector_logits"],
                                                 outs["mask"], msg, bit_mask=mask)
                + lc.lambda_loc * jlocalization_loss(outs["locator_logits"],
                                                     outs["mask"]))

    d_grads, _ = jclip(jax.jit(jax.grad(d_loss))(disc), 10.0)
    updates, _ = disc_tx.update(d_grads, disc_tx.init(disc), disc)
    updated = optax.apply_updates(disc, updates)
    grad_fn = jax.jit(jax.grad(g_loss))
    grads = {}
    for name, gate in GATES.items():
        g = gate or NEUTRAL
        mask = jnp.asarray((np.arange(16) < g["n_bits"]).astype(np.float32))
        wg = grad_fn(wm, updated if g["train_disc"] else disc,
                     np.float32(g["percep_scale"]), np.bool_(g["train_disc"]), mask)
        gen, _ = jclip(wg["generator"], 10.0)
        flat = {net: {k: np.asarray(v) for k, v in _flatten(wg[net]).items()}
                for net in ("detector", "locator")}
        flat["generator"] = {
            k: np.asarray(v) * g["gen_update_scale"] * (
                g["msg_update_scale"] if any(p.startswith(("msg_", "film_"))
                                             for p in k.split("/")) else 1.0)
            for k, v in _flatten(gen).items()}
        if g["train_disc"]:
            flat["discriminator"] = {k: np.asarray(v)
                                     for k, v in _flatten(d_grads).items()}
        grads[name] = flat
    return grads


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("net", NETS)
def test_split_step_grads_match_jax(port_steps, jax_grads, gate, net):
    """Each network's gradient leaves against JAX's within GRAD_TOL; without
    the discriminator's step it has no gradient."""
    module = getattr(port_steps[gate].models, net)
    if net == "discriminator" and "discriminator" not in jax_grads[gate]:
        assert all(p.grad is None for p in module.parameters())
        return
    ours = export_grads(module)
    ref = jax_grads[gate][net]
    assert set(ours) == set(ref)
    dev = {k: float(np.linalg.norm(ours[k] - ref[k]))
           / max(float(np.linalg.norm(ref[k])), 1e-30) for k in ref}
    worst = max(dev, key=dev.get)
    assert dev[worst] <= GRAD_TOL[net], (worst, dev[worst])
