"""One training step with the 20-branch bank (the 9 shipped branches and
the 11 new on-device effects) against the JAX package's step at the tiny
size, f32 on the CPU: each of the 20 samples on its own branch, the port
fed the JAX key chain's draws of every random branch. Held as
``test_torch_train.py`` holds the 9-branch step: losses, gradient norms,
every parameter's gradient leaf by leaf, parameters after the step.

Two limits differ, for what 20 samples show that 4 did not. (i) A leaf's
deviation is relative to its own norm, or to 1e-6 of its network's when
that is larger: at random init some FiLM biases of the generator's first
scale read ~1e-16 (f32 cancellation), and the port's own step moves them
by 29% of themselves when the audio moves by 1e-7 relative. (ii) A
network's worst leaf is held to ``GRAD_TOL`` or four times the port's own
spread at audio * (1 +- 1e-7), whichever is larger (the detector's own
spread read 9.9e-05 here against its 1e-4 limit). And one locator
decision may flip at the threshold in a sample's MIoU (at most 1 / T)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_catalog import BANK20
from tests.test_torch_train import GRAD_TOL, _flatten, _rel, export_grads
from tests.torch_jax_bridge import jax_draws, jax_params, tiny_configs
from waveverify_tpu.effects.effects import EffectBank as JBank
from waveverify_tpu.losses import decoding_loss as jdecoding_loss
from waveverify_tpu.losses import discriminator_loss as jdiscriminator_loss
from waveverify_tpu.losses import generator_loss as jgenerator_loss
from waveverify_tpu.losses import l1_loss as jl1_loss
from waveverify_tpu.losses import localization_loss as jlocalization_loss
from waveverify_tpu.losses import mel_spectrogram_loss as jmel_loss
from waveverify_tpu.losses import multi_scale_stft_loss as jstft_loss
from waveverify_tpu.train.state import TrainState as JTrainState
from waveverify_tpu.train.state import clip_by_global_norm as jclip
from waveverify_tpu.train.state import make_optimizers
from waveverify_tpu.train.step import make_train_step
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_tpu.train.watermarking import forward_train as jforward_train
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.train.state import create_train_state
from waveverify_torch.train.step import train_step
from waveverify_torch.weights import export_params

torch.set_num_threads(2)

B, T = 20, 1920
KEY = jax.random.PRNGKey(13)
NETS = ["generator", "detector", "locator", "discriminator"]


def _inputs():
    rng = np.random.RandomState(1)
    audio = (rng.randn(B, T) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (B, 16)).astype(np.float32)
    idx = rng.permutation(B).astype(np.int32)
    return audio, msg, idx


def _port_step(tcfg, scale=1.0):
    audio, msg, idx = _inputs()
    state = create_train_state(tcfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    d = jax_draws(KEY, 0, B, T, BANK20)
    metrics = train_step(state, tcfg, EffectBank(BANK20),
                         torch.from_numpy(audio) * scale,
                         torch.from_numpy(msg), idx, d)
    return state, metrics


@pytest.fixture(scope="module")
def steps():
    """The JAX step, the port's, the port's at audio * (1 +- 1e-7) (its own
    f32 spread), and JAX's clipped gradients of the step's two losses."""
    jcfg, tcfg = tiny_configs(B, remat=False)
    init = create_train_state(tcfg, torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    jmodels = JModels.from_config(jcfg)
    wm, disc = jax_params(init.models)
    wm_tx, disc_tx = make_optimizers(jcfg.optim)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), wm_params=wm,
                         disc_params=disc, wm_opt_state=wm_tx.init(wm),
                         disc_opt_state=disc_tx.init(disc))
    audio, msg, idx = _inputs()
    jbank = JBank(BANK20)
    jnew, jm = jax.jit(make_train_step(jmodels, jcfg, jbank))(
        jstate, audio, msg, idx, KEY)
    state, tm = _port_step(tcfg)
    spread = [_port_step(tcfg, 1 + e) for e in (1e-7, -1e-7)]

    lc = jcfg.loss
    a, m, i = map(jnp.asarray, (audio, msg, idx))
    k_fwd, k_gp = jax.random.split(jax.random.fold_in(KEY, 0))

    def g_loss(wp):
        outs = jforward_train(jmodels, wp, k_fwd, a, m, i, jbank,
                              window_duration=jcfg.window_duration, remat=False)
        w = outs["watermarked"]
        adv, _ = jgenerator_loss(
            lambda x: jmodels.apply_discriminator(jnew.disc_params, x), w, a)
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
                                                     outs["mask"])), outs["residual"]

    def d_loss(dp, fake):
        return jdiscriminator_loss(lambda x: jmodels.apply_discriminator(dp, x),
                                   fake, a, key=k_gp, gp_weight=lc.gp_weight)

    (_, fake), wm_grads = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(wm)
    d_grads = jax.jit(jax.grad(d_loss))(disc, fake)
    grads = dict(wm_grads, discriminator=d_grads)
    for net in ("generator", "discriminator"):
        grads[net], _ = jclip(grads[net], 10.0)
    return jnew, jm, state, tm, spread, grads


@pytest.mark.parametrize("name", ["loss", "stft/loss", "mel/loss", "waveform/loss",
                                  "adv/gen_loss", "dec/loss", "loc/loss",
                                  "adv/disc_loss", "train/ber", "train/miou",
                                  "grad_norm/generator", "grad_norm/discriminator"])
def test_catalog_step_metrics_match_jax(steps, name):
    """Losses within rel 1e-4; gradient norms within rel 1e-4 or three
    times the port's own spread at audio * (1 +- 1e-7), as in
    ``test_torch_train.py``."""
    _, jm, _, tm, spread, _ = steps
    floor = (max(_rel(m[name], tm[name]) for _, m in spread)
             if "grad_norm" in name else 0.0)
    assert _rel(tm[name], jm[name]) <= max(1e-4, 3 * floor), (
        name, float(tm[name]), float(jm[name]), floor)


def test_catalog_step_feedback_matches_jax(steps):
    _, jm, _, tm, _, _ = steps
    for k in ("per_sample_ber", "per_bit_acc"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tm["per_sample_miou"].numpy(),
                               np.asarray(jm["per_sample_miou"]), atol=1.0 / T)


def _leaf_devs(ours, ref):
    """Per leaf: ||ours - ref|| / max(||ref||, 1e-6 ||ref's network||)."""
    floor = 1e-6 * float(np.sqrt(sum(np.linalg.norm(v) ** 2 for v in ref.values())))
    return {k: float(np.linalg.norm(ours[k] - ref[k]))
            / max(float(np.linalg.norm(ref[k])), floor) for k in ref}


@pytest.mark.parametrize("net", NETS)
def test_catalog_step_grads_match_jax(steps, net):
    """Every parameter's gradient against JAX's (clipped as each step clips
    it), the worst leaf within ``GRAD_TOL`` or four times the port's own
    spread."""
    state, spread, grads = steps[2], steps[4], steps[5]
    ours = export_grads(getattr(state.models, net))
    ref = {k: np.asarray(v) for k, v in _flatten(grads[net]).items()}
    assert set(ours) == set(ref)
    own = max(max(_leaf_devs(export_grads(getattr(s.models, net)), ours).values())
              for s, _ in spread)
    dev = _leaf_devs(ours, ref)
    worst = max(dev, key=dev.get)
    assert dev[worst] <= max(GRAD_TOL[net], 4 * own), (worst, dev[worst], own)


@pytest.mark.parametrize("net", NETS)
def test_catalog_step_params_within_2lr(steps, net):
    jnew, _, state, _, _, _ = steps
    ours = export_params(getattr(state.models, net), net)
    tree = jnew.disc_params if net == "discriminator" else jnew.wm_params[net]
    flat = {f"{net}/{k}": np.asarray(v) for k, v in _flatten(tree).items()}
    assert set(ours) == set(flat)
    # a gradient sign the two sides round apart costs 2 lr, plus the f32
    # rounding of the parameter itself
    lr = 1e-4
    for k in ours:
        assert np.all(np.abs(ours[k] - flat[k])
                      <= 2 * lr + 4 * np.spacing(np.abs(flat[k]))), k
