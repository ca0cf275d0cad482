"""The port's training step against the JAX package at a tiny size, f32 on
the CPU: the composite forward, one whole train step, the same step under
the training controllers' inputs, the optimizer alone, the validation
step; and within the port, remat on vs off and the chain weight cache
across an optimizer step."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_jax_bridge import (
    jax_draws,
    jax_localization_draws,
    jax_params,
    jax_sequence_draws,
    tiny_configs,
    unflatten,
)
from waveverify_tpu.effects.augment import localization_augmentation as jlocalization
from waveverify_tpu.effects.augment import sequence_augmentation as jsequence
from waveverify_tpu.effects.effects import EffectBank as JBank
from waveverify_tpu.losses import decoding_loss as jdecoding_loss
from waveverify_tpu.losses import discriminator_loss as jdiscriminator_loss
from waveverify_tpu.losses import generator_loss as jgenerator_loss
from waveverify_tpu.losses import l1_loss as jl1_loss
from waveverify_tpu.losses import localization_loss as jlocalization_loss
from waveverify_tpu.losses import mel_spectrogram_loss as jmel_loss
from waveverify_tpu.losses import multi_scale_stft_loss as jstft_loss
from waveverify_tpu.train.state import clip_by_global_norm as jclip
from waveverify_tpu.train.state import TrainState as JTrainState
from waveverify_tpu.train.state import make_optimizers
from waveverify_tpu.train.step import make_train_step, make_val_step
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_tpu.train.watermarking import forward_train as jforward_train
from waveverify_torch.config import OptimConfig
from waveverify_torch.effects.augment import (
    localization_augmentation,
    sequence_augmentation,
)
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.train.state import create_train_state, make_optimizer, wm_param_groups
from waveverify_torch.train.step import train_step, val_step
from waveverify_torch.train.watermarking import Draws, draw, forward_train
from waveverify_torch.weights import export_params

torch.set_num_threads(2)

B, T = 4, 3200
BANK = [("identity", {}), ("highpass_filter", {"cutoff_freq": 500}),
        ("random_noise", {"noise_std": 0.001}), ("speed", {"speed": 0.8})]
EVAL = [("identity", {}), ("random_noise", {"noise_std": 0.001}),
        ("lowpass_filter", {"cutoff_freq": 2000})]
KEY = jax.random.PRNGKey(5)
NETS = ["generator", "detector", "locator", "discriminator"]
# the worst leaf's relative norm of (port - JAX) that a step may show: about
# four times the readings (generator 4.0e-3, detector 2.0e-5, locator 2.4e-6,
# discriminator 5.1e-3), which match the port's own spread when the audio
# moves by 1e-7 relative (5.1e-3, 2.2e-5, 4.6e-6, 1.8e-3): the log-STFT
# features of the spec blocks, and the gradient penalty, amplify f32
# rounding at random init. A gradient that is missing, detached or of the
# wrong sign is off by about 1.
GRAD_TOL = {"generator": 2e-2, "detector": 1e-4, "locator": 2e-5,
            "discriminator": 2e-2}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _inputs():
    rng = np.random.RandomState(0)
    audio = (rng.randn(B, T) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (B, 16)).astype(np.float32)
    idx = np.array([0, 1, 2, 3], np.int32)
    return audio, msg, idx


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_configs(B, remat=False)
    init = create_train_state(tcfg, torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    jmodels = JModels.from_config(jcfg)
    wm, disc = jax_params(init.models)
    wm_tx, disc_tx = make_optimizers(jcfg.optim)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), wm_params=wm,
                         disc_params=disc, wm_opt_state=wm_tx.init(wm),
                         disc_opt_state=disc_tx.init(disc))
    return jcfg, tcfg, jmodels, jstate, init


def test_forward_train_matches_jax(setup):
    """The composite forward, stage by stage: the generator's outputs and
    the augment-and-attack segment against JAX's; the detector and locator
    on the port's attacked audio against JAX's networks on the same audio.
    (End to end, the random-init networks amplify the packages' f32
    rounding of the residual far beyond 1e-5 in the locator's logits.)"""
    jcfg, tcfg, jmodels, jstate, init = setup
    audio, msg, idx = _inputs()
    jbank, bank = JBank(BANK), EffectBank(BANK)
    k_fwd, _ = jax.random.split(jax.random.fold_in(KEY, 0))
    k_loc, k_seq, k_fx, _, _ = jax.random.split(k_fwd, 5)
    ref = jax.jit(lambda p, a, m, i: jforward_train(
        jmodels, p, k_fwd, a, m, i, jbank, remat=False))(
            jstate.wm_params, audio, msg, idx)
    d = jax_draws(KEY, 0, B, T, len(BANK), bank.noise_branches)
    with torch.no_grad():
        out = forward_train(init.models, torch.from_numpy(audio),
                            torch.from_numpy(msg), idx, bank, d, remat=False)
    for k in ("residual", "watermarked", "mask", "updated_original"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)

    def jax_attack(w, a, i):
        aug, mask, _ = jlocalization(k_loc, a, w)
        aug, _, mask = jsequence(k_seq, aug, a, mask)
        return jbank.apply(aug, mask, i, k_fx)[0]

    fx_ref = jax.jit(jax_attack)(ref["watermarked"], audio, idx)
    with torch.no_grad():
        a = torch.from_numpy(audio)
        aug, mask, orig = localization_augmentation(
            a, out["watermarked"], d.loc_scores, d.loc_probs, d.loc_offset)
        aug, _, mask = sequence_augmentation(aug, orig, mask, d.seq_u,
                                             d.seq_shift, d.seq_perm)
        fx = bank.apply(aug, mask, idx, d.noise)[0]
        det, loc = (init.models.apply_detector(fx),
                    init.models.apply_locator(fx))
    np.testing.assert_allclose(fx.numpy(), np.asarray(fx_ref), rtol=1e-5,
                               atol=1e-5)
    fx_np = fx.numpy()
    det_ref = jax.jit(jmodels.apply_detector)(jstate.wm_params["detector"], fx_np)
    loc_ref = jax.jit(jmodels.apply_locator)(jstate.wm_params["locator"], fx_np)
    np.testing.assert_allclose(det.numpy(), np.asarray(det_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(out["detector_logits"].numpy(), det.numpy())
    np.testing.assert_array_equal(out["locator_logits"].numpy(), loc.numpy())


def _port_step(tcfg, audio, msg, idx, scale=1.0):
    """The port's step from the seed-0 state on ``audio * scale``."""
    state = create_train_state(tcfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    bank = EffectBank(BANK)
    d = jax_draws(KEY, 0, B, T, len(BANK), bank.noise_branches)
    metrics = train_step(state, tcfg, bank, torch.from_numpy(audio) * scale,
                         torch.from_numpy(msg), idx, d)
    return state, metrics


@pytest.fixture(scope="module")
def one_step(setup):
    """The JAX step and the port's, from the same parameters and draws."""
    jcfg, tcfg, jmodels, jstate, init = setup
    audio, msg, idx = _inputs()
    step = jax.jit(make_train_step(jmodels, jcfg, JBank(BANK)))
    jnew, jm = step(jstate, audio, msg, idx, KEY)
    state, tm = _port_step(tcfg, audio, msg, idx)
    return jnew, jm, state, tm


LOSSES = ["loss", "stft/loss", "mel/loss", "waveform/loss", "adv/gen_loss",
          "adv/feat_loss", "dec/loss", "loc/loss", "adv/disc_loss",
          "train/ber", "train/miou"]


@pytest.mark.parametrize("name", LOSSES)
def test_train_step_losses_match_jax(one_step, name):
    _, jm, _, tm = one_step
    assert _rel(tm[name], jm[name]) <= 1e-4, (name, float(tm[name]), float(jm[name]))


@pytest.fixture(scope="module")
def noise_floor(setup, one_step):
    """How far the port's gradient norms move when the audio is scaled by
    1 +- 1e-7 (relative): the f32 noise floor of the comparison."""
    _, tcfg, _, _, _ = setup
    tm = one_step[3]
    audio, msg, idx = _inputs()
    runs = [_port_step(tcfg, audio, msg, idx, 1 + e)[1] for e in (1e-7, -1e-7)]
    return {name: max(_rel(m[name], tm[name]) for m in runs)
            for name in ("grad_norm/generator", "grad_norm/discriminator")}


@pytest.mark.parametrize("name", ["grad_norm/generator", "grad_norm/discriminator"])
def test_train_step_grad_norms_match_jax(one_step, noise_floor, name):
    """Pre-clip gradient norms within rel 1e-4, or within three times the
    port's own f32 noise floor where that is larger. The log-STFT features
    of the spec blocks make the input gradient ill-conditioned at random
    init, so in either package the generator's norm moves visibly when the
    audio is scaled by 1 +- 1e-7; the fixture measures how far."""
    _, jm, _, tm = one_step
    floor = noise_floor[name]
    assert _rel(tm[name], jm[name]) <= max(1e-4, 3 * floor), (
        name, float(tm[name]), float(jm[name]), floor)


def test_train_step_feedback_matches_jax(one_step):
    _, jm, _, tm = one_step
    for k in ("per_sample_ber", "per_sample_miou", "per_bit_acc"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_grads(setup, one_step):
    """JAX's gradients of the step's two losses, leaf by leaf, clipped as
    ``make_train_step`` clips them: the discriminator loss's at the initial
    discriminator, the generator total's against the discriminator that
    JAX's step updated. Built from the JAX package's own functions in
    ``make_train_step``'s order; returns the losses and pre-clip norms
    too, so a test can hold them to the step's."""
    jcfg, _, jmodels, jstate, _ = setup
    jnew = one_step[0]
    lc = jcfg.loss
    assert lc.lambda_dec_clean == lc.lambda_dec_bits == lc.lambda_dec_lowband == 0
    audio, msg, idx = map(jnp.asarray, _inputs())
    k_fwd, k_gp = jax.random.split(jax.random.fold_in(KEY, 0))
    jbank = JBank(BANK)

    def fwd(wm):
        return jforward_train(jmodels, wm, k_fwd, audio, msg, idx, jbank,
                              window_duration=jcfg.window_duration, remat=False)

    def d_loss(dp, fake):
        return jdiscriminator_loss(lambda x: jmodels.apply_discriminator(dp, x),
                                   fake, audio, key=k_gp, gp_weight=lc.gp_weight)

    def g_loss(wm):
        outs = fwd(wm)
        w = outs["watermarked"]
        adv, _ = jgenerator_loss(
            lambda x: jmodels.apply_discriminator(jnew.disc_params, x), w, audio)
        return (lc.lambda_stft * jstft_loss(
                    w, audio, window_lengths=lc.stft_window_lengths)
                + lc.lambda_mel * jmel_loss(
                    w, audio, n_mels=lc.mel_n_mels,
                    window_lengths=lc.mel_window_lengths,
                    clamp_eps=lc.mel_clamp_eps, mag_weight=lc.mel_mag_weight,
                    pow=lc.mel_pow)
                + lc.lambda_waveform * jl1_loss(w, audio)
                + lc.lambda_adv_gen * adv
                + lc.lambda_dec * jdecoding_loss(outs["detector_logits"],
                                                 outs["mask"], msg)
                + lc.lambda_loc * jlocalization_loss(outs["locator_logits"],
                                                     outs["mask"])), outs["residual"]

    (g_val, fake), wm_grads = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(
        jstate.wm_params)
    d_val, d_grads = jax.jit(jax.value_and_grad(d_loss))(jstate.disc_params, fake)
    grads = dict(wm_grads, discriminator=d_grads)
    out = {"adv/disc_loss": d_val, "loss": g_val}
    for net in ("generator", "discriminator"):
        grads[net], out[f"grad_norm/{net}"] = jclip(grads[net], 10.0)
    return grads, out


@pytest.mark.parametrize("name", ["loss", "adv/disc_loss", "grad_norm/generator",
                                  "grad_norm/discriminator"])
def test_jax_grads_reproduce_jax_step(one_step, noise_floor, jax_grads, name):
    """The gradients the next test holds the port to are those of JAX's
    step: the losses they differentiate are the step's, and so are their
    norms (within the tolerance of the grad-norm test)."""
    jm = one_step[1]
    tol = max(1e-4, 3 * noise_floor.get(name, 0.0))
    assert _rel(jax_grads[1][name], jm[name]) <= tol, (
        name, float(jax_grads[1][name]), float(jm[name]))


@pytest.mark.parametrize("net", NETS)
def test_train_step_grads_match_jax(one_step, jax_grads, net):
    """Every parameter's gradient in the port's step against JAX's, by the
    relative norm of the difference, clipped as each step clips it."""
    state = one_step[2]
    ours = export_grads(getattr(state.models, net))
    ref = {k: np.asarray(v) for k, v in _flatten(jax_grads[0][net]).items()}
    assert set(ours) == set(ref)
    dev = {k: float(np.linalg.norm(ours[k] - ref[k]))
           / max(float(np.linalg.norm(ref[k])), 1e-30) for k in ref}
    worst = max(dev, key=dev.get)
    assert dev[worst] <= GRAD_TOL[net], (worst, dev[worst])


@pytest.mark.parametrize("net", NETS)
def test_train_step_params_within_2lr(one_step, net):
    """Adam's first step moves a parameter by about lr wherever |g| >> eps,
    so a gradient sign the two sides round apart costs at most 2 lr."""
    jnew, _, state, _ = one_step
    lr = 1e-4
    ours = export_params(getattr(state.models, net), net)
    tree = (jnew.disc_params if net == "discriminator"
            else jnew.wm_params[net])
    flat = {f"{net}/{k}": np.asarray(v) for k, v in
            _flatten(tree).items()}
    assert set(ours) == set(flat)
    worst = max(float(np.abs(ours[k] - flat[k]).max()) for k in ours)
    assert worst <= 2 * lr, worst


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def test_optimizer_matches_optax():
    """AdamW with the decay mask, the lr multipliers and the exponential
    schedule, and the clip, over 3 steps on identical gradients."""
    cfg = OptimConfig(detector_lr_mult=3.0, generator_lr_mult=2.0, lr=1e-3,
                      exp_gamma=0.9)
    _, tcfg = tiny_configs(B)
    state = create_train_state(tcfg, torch.Generator().manual_seed(1),
                               torch.device("cpu"))
    models = state.models
    opt, sched = make_optimizer(wm_param_groups(models, cfg), cfg)
    wm, _ = jax_params(models)
    from waveverify_tpu.config import OptimConfig as JOptimConfig

    wm_tx, _ = make_optimizers(JOptimConfig(**dataclasses.asdict(cfg)))
    from waveverify_tpu.train.state import clip_by_global_norm

    jopt = wm_tx.init(wm)

    @jax.jit
    def jax_update(grads, jopt, wm):
        gen, jnorm = clip_by_global_norm(grads["generator"], 10.0)
        updates, jopt = wm_tx.update(dict(grads, generator=gen), jopt, wm)
        return optax.apply_updates(wm, updates), jopt, jnorm

    rng = np.random.RandomState(2)
    for _ in range(3):
        grads = {}
        for net in ("generator", "detector", "locator"):
            for name, p in getattr(models, net).named_parameters():
                p.grad = torch.from_numpy(
                    rng.randn(*p.shape).astype(np.float32) * 3.0)
            grads[net] = unflatten(export_grads(getattr(models, net)))
        g_norm = torch.nn.utils.clip_grad_norm_(models.generator.parameters(), 10.0)
        opt.step()
        sched.step()
        wm, jopt, jnorm = jax_update(grads, jopt, wm)
        assert _rel(g_norm, jnorm) <= 1e-6
        for net in ("generator", "detector", "locator"):
            ours = export_params(getattr(models, net), net)
            for k, v in _flatten(wm[net]).items():
                np.testing.assert_allclose(ours[f"{net}/{k}"], np.asarray(v),
                                           atol=1e-6, rtol=1e-6, err_msg=k)


def export_grads(module):
    """The module's gradients under its parameters' flax paths and layouts."""
    saved = {n: p.data.clone() for n, p in module.named_parameters()}
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.grad)
    flat = export_params(module, "x")
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(saved[n])
    return {k[2:]: v for k, v in flat.items()}


def test_val_step_matches_jax(setup):
    jcfg, tcfg, jmodels, jstate, init = setup
    audio, msg, _ = _inputs()
    key = jax.random.PRNGKey(9)
    ref = jax.jit(make_val_step(jmodels, jcfg, EVAL))(jstate, audio, msg, key)
    # the validation key chain: localization, sequence, then one key per
    # effect of the sweep
    k_loc, k_seq, k = jax.random.split(key, 3)
    noise = []
    for name, _ in EVAL:
        k, sub = jax.random.split(k)
        if name == "random_noise":
            noise.append(np.asarray(jax.random.normal(sub, (B, T))))
    d = Draws(*jax_localization_draws(k_loc, B, T), *jax_sequence_draws(k_seq, T),
              torch.from_numpy(np.stack(noise)))
    out = val_step(init, tcfg, torch.from_numpy(audio), torch.from_numpy(msg),
                   d, EVAL)
    assert set(out) == set(ref)
    for name in out:
        # BER and MIoU count thresholded decisions; the random-init locator
        # amplifies the packages' f32 rounding, so a sample at the
        # threshold may flip: 1e-3 is a few of the 12800 samples
        tol = 1e-3 if "/ber" in name or "/miou" in name else 1e-5
        assert abs(float(out[name]) - float(ref[name])) <= tol * max(
            1.0, abs(float(ref[name]))), (name, float(out[name]), float(ref[name]))


def test_remat_on_equals_off():
    _, tcfg = tiny_configs(B)
    audio, msg, idx = _inputs()
    bank = EffectBank(BANK)
    d = draw(torch.Generator().manual_seed(4), B, T, len(bank.noise_branches))
    results = []
    for remat in (True, False):
        state = create_train_state(tcfg, torch.Generator().manual_seed(3),
                                   torch.device("cpu"))
        m = train_step(state, dataclasses.replace(tcfg, remat=remat), bank,
                       torch.from_numpy(audio), torch.from_numpy(msg), idx, d)
        results.append((m, state))
    (m1, s1), (m0, s0) = results
    for k in ("loss", "adv/disc_loss", "grad_norm/generator",
              "grad_norm/discriminator"):
        assert _rel(m1[k], m0[k]) <= 1e-5, k
    for (n, p1), p0 in zip(s1.models.named_parameters(), s0.models.parameters()):
        torch.testing.assert_close(p1, p0, atol=1e-6, rtol=1e-5, msg=n)


def test_chain_cache_sees_optimizer_step():
    """A no-grad forward after optimizer.step() uses the new weights, not
    the stacked copy cached before the step."""
    _, tcfg = tiny_configs(B)
    audio, msg, idx = _inputs()
    bank = EffectBank(BANK)
    state = create_train_state(tcfg, torch.Generator().manual_seed(5),
                               torch.device("cpu"))
    a, m = torch.from_numpy(audio), torch.from_numpy(msg)
    with torch.no_grad():
        before = state.models.apply_generator(a, m)
    train_step(state, tcfg, bank, a, m, idx,
               draw(torch.Generator().manual_seed(6), B, T, len(bank.noise_branches)))
    with torch.no_grad():
        after = state.models.apply_generator(a, m)
        fresh = copy.deepcopy(state.models).apply_generator(a, m)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


# the controllers' inputs of one step (train/loop.py step_inputs): every
# gate closed, as a fresh r5-recipe run starts; the discriminator on with
# the message path frozen (a squeezing ramp's scale); the generator on and
# the discriminator off, 8 bits active
GATES = {
    "closed": dict(percep_scale=0.0, train_disc=False, gen_update_scale=0.0,
                   msg_update_scale=0.0, n_bits=4),
    "disc_on_msg_frozen": dict(percep_scale=0.015357952969989128,
                               train_disc=True, gen_update_scale=1.0,
                               msg_update_scale=0.0, n_bits=4),
    "gen_on_disc_off": dict(percep_scale=0.3, train_disc=False,
                            gen_update_scale=1.0, msg_update_scale=1.0,
                            n_bits=8),
}


@pytest.fixture(scope="module")
def gated_steps(setup):
    """For each entry of GATES, JAX ``make_train_step``'s step (compiled
    once: the five inputs are traced) and the port's, from the same
    parameters, draws and inputs."""
    jcfg, tcfg, jmodels, jstate, _ = setup
    audio, msg, idx = _inputs()
    jstep = jax.jit(make_train_step(jmodels, jcfg, JBank(BANK)))
    bank = EffectBank(BANK)
    d = jax_draws(KEY, 0, B, T, len(BANK), bank.noise_branches)
    out = {}
    for name, g in GATES.items():
        mask = (np.arange(16) < g["n_bits"]).astype(np.float32)
        jnew, jm = jstep(jstate, audio, msg, idx, KEY,
                         np.float32(g["percep_scale"]), np.bool_(g["train_disc"]),
                         np.float32(g["gen_update_scale"]),
                         np.float32(g["msg_update_scale"]), mask)
        state = create_train_state(tcfg, torch.Generator().manual_seed(0),
                                   torch.device("cpu"))
        tm = train_step(state, tcfg, bank, torch.from_numpy(audio),
                        torch.from_numpy(msg), idx, d,
                        percep_scale=g["percep_scale"], train_disc=g["train_disc"],
                        gen_update_scale=g["gen_update_scale"],
                        msg_update_scale=g["msg_update_scale"],
                        bit_mask=torch.from_numpy(mask))
        out[name] = (jnew, jm, state, tm)
    return out


@pytest.fixture(scope="module")
def gated_jax_grads(setup, one_step, jax_grads):
    """For each entry of GATES, JAX's gradients of the gated step's
    generator total, built from the JAX package's functions as
    ``make_train_step`` gates them: ``percep_scale`` on the perceptual and
    adversarial terms, the adversarial terms only with ``train_disc``
    (against the updated discriminator), ``bit_mask`` in the decoding
    loss; the generator's clipped, then multiplied by ``gen_update_scale``
    and its message path's by ``msg_update_scale``. The discriminator's are
    the ungated step's (its update does not see the gates). One compile."""
    jcfg, _, jmodels, jstate, _ = setup
    lc = jcfg.loss
    audio, msg, idx = map(jnp.asarray, _inputs())
    k_fwd, _ = jax.random.split(jax.random.fold_in(KEY, 0))
    jbank = JBank(BANK)
    jnew = one_step[0]

    def g_loss(wm, percep, adv_on, mask):
        outs = jforward_train(jmodels, wm, k_fwd, audio, msg, idx, jbank,
                              window_duration=jcfg.window_duration, remat=False)
        w = outs["watermarked"]
        adv = jax.lax.cond(adv_on, lambda w_: jgenerator_loss(
            lambda x: jmodels.apply_discriminator(jnew.disc_params, x), w_,
            audio)[0], lambda w_: jnp.float32(0.0), w)
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

    grad_fn = jax.jit(jax.value_and_grad(g_loss))
    out = {}
    for name, g in GATES.items():
        mask = jnp.asarray((np.arange(16) < g["n_bits"]).astype(np.float32))
        val, grads = grad_fn(jstate.wm_params, np.float32(g["percep_scale"]),
                             np.bool_(g["train_disc"]), mask)
        gen, _ = jclip(grads["generator"], 10.0)
        gen = {k: v * g["gen_update_scale"] * (
            g["msg_update_scale"] if any(p.startswith(("msg_", "film_"))
                                         for p in k.split("/")) else 1.0)
            for k, v in _flatten(gen).items()}
        flat = {net: {k: np.asarray(v) for k, v in _flatten(grads[net]).items()}
                for net in ("detector", "locator")}
        flat["generator"] = {k: np.asarray(v) for k, v in gen.items()}
        flat["discriminator"] = {k: np.asarray(v) for k, v in
                                 _flatten(jax_grads[0]["discriminator"]).items()}
        out[name] = (float(val), flat)
    return out


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("name", LOSSES)
def test_gated_step_losses_match_jax(gated_steps, gated_jax_grads, gate, name):
    """The step under the controllers' inputs: each loss as JAX's step
    reports it (the adversarial ones 0 without the discriminator); the
    total also equals the gated loss the gradients below differentiate."""
    _, jm, _, tm = gated_steps[gate]
    assert _rel(tm[name], jm[name]) <= 1e-4, (name, float(tm[name]), float(jm[name]))
    if name == "loss":
        assert _rel(gated_jax_grads[gate][0], jm["loss"]) <= 1e-4
    if name in ("adv/gen_loss", "adv/feat_loss", "adv/disc_loss") and not (
            GATES[gate]["train_disc"]):
        assert float(tm[name]) == float(jm[name]) == 0.0


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("net", NETS)
def test_gated_step_grads_match_jax(gated_steps, gated_jax_grads, gate, net):
    """The gradients each network's update took, leaf by leaf, against
    JAX's gated gradients (GRAD_TOL); without ``train_disc`` the
    discriminator takes none and stays as it was, in both packages."""
    jnew, _, state, _ = gated_steps[gate]
    module = getattr(state.models, net)
    if net == "discriminator" and not GATES[gate]["train_disc"]:
        assert all(p.grad is None for p in module.parameters())
        init = export_params(create_train_state(
            tiny_configs(B)[1], torch.Generator().manual_seed(0),
            torch.device("cpu")).models.discriminator, "d")
        ours = export_params(module, "d")
        ref = {f"d/{k}": np.asarray(v) for k, v in _flatten(jnew.disc_params).items()}
        for k in init:
            np.testing.assert_array_equal(ours[k], init[k], err_msg=k)
            np.testing.assert_array_equal(ref[k], init[k], err_msg=k)
        return
    ours = export_grads(module)
    ref = gated_jax_grads[gate][1][net]
    assert set(ours) == set(ref)
    dev = {k: float(np.linalg.norm(ours[k] - ref[k]))
           / max(float(np.linalg.norm(ref[k])), 1e-30) for k in ref}
    worst = max(dev, key=dev.get)
    assert dev[worst] <= GRAD_TOL[net], (worst, dev[worst])


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gated_step_params_within_2lr(gated_steps, gate):
    """Every parameter after the gated step within 2 lr of JAX's."""
    jnew, _, state, _ = gated_steps[gate]
    for net in NETS:
        ours = export_params(getattr(state.models, net), net)
        tree = jnew.disc_params if net == "discriminator" else jnew.wm_params[net]
        ref = {f"{net}/{k}": np.asarray(v) for k, v in _flatten(tree).items()}
        assert set(ours) == set(ref)
        worst = max(float(np.abs(ours[k] - ref[k]).max()) for k in ours)
        assert worst <= 2e-4, (net, worst)


def _msg_leaf(key):
    return any(p.startswith(("msg_", "film_")) for p in key.split("/"))


def test_frozen_generator_only_decays(setup, gated_steps):
    """gen_update_scale = 0 from fresh moments: AdamW sees zero gradients,
    so each generator leaf is its start times (1 - lr wd) where it takes
    weight decay and unchanged where it does not (the message path), in
    the port bit for bit and in JAX within f32 rounding."""
    _, tcfg, _, _, init = setup
    jnew, _, state, _ = gated_steps["closed"]
    lr = tcfg.optim.lr * tcfg.optim.generator_lr_mult
    p0 = export_params(init.models.generator, "g")
    ours = export_params(state.models.generator, "g")
    ref = {f"g/{k}": np.asarray(v) for k, v in _flatten(jnew.wm_params["generator"]).items()}
    assert any(_msg_leaf(k) for k in p0) and not all(_msg_leaf(k) for k in p0)
    for k, v in p0.items():
        want = v if _msg_leaf(k) else (torch.from_numpy(v) * (1 - lr * 0.01)).numpy()
        np.testing.assert_array_equal(ours[k], want, err_msg=k)
        np.testing.assert_allclose(ref[k], want, rtol=1e-6, atol=0, err_msg=k)


def test_frozen_message_path_is_unchanged(setup, gated_steps):
    """msg_update_scale = 0: the generator's msg_* / film_* leaves keep
    their values bit for bit in both packages while the rest of it moves."""
    _, _, _, _, init = setup
    jnew, _, state, _ = gated_steps["disc_on_msg_frozen"]
    p0 = export_params(init.models.generator, "g")
    ours = export_params(state.models.generator, "g")
    ref = {f"g/{k}": np.asarray(v) for k, v in _flatten(jnew.wm_params["generator"]).items()}
    for k, v in p0.items():
        if _msg_leaf(k):
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
            np.testing.assert_array_equal(ref[k], v, err_msg=k)
    moved = [k for k in p0 if not _msg_leaf(k) and not np.array_equal(ours[k], p0[k])]
    assert len(moved) == sum(not _msg_leaf(k) for k in p0)
