"""K steps per dispatch (``train_steps``) against the JAX package's
``make_multi_train_step``, f32 on the CPU at the tiny configuration, at
K = 2 with the discriminator vector ``[True, False]`` (K = 3 is in
``test_torch_multi_step_k3.py``, so that the two JAX compiles run on two
workers); K single port steps against ``train_steps``; and the
dispatch's host inputs (the disc vector, the held controllers, the
feedback means) against the JAX loop's formulas
(``waveverify_tpu/train/loop.py:717-905``), state for state against the
JAX package's controller classes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import BANK, KEY, NETS, _flatten, _rel
from tests.torch_jax_bridge import jax_draws, jax_params, tiny_configs
from waveverify_tpu.effects.effects import EffectBank as JBank
from waveverify_tpu.train.loop import BerGatedRamp as JRamp
from waveverify_tpu.train.loop import NbitsCurriculum as JCurriculum
from waveverify_tpu.train.state import TrainState as JTrainState
from waveverify_tpu.train.state import make_optimizers
from waveverify_tpu.train.step import make_multi_train_step
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_torch.config import LossConfig
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.train.loop import (
    BerGatedRamp,
    NbitsCurriculum,
    dispatch_inputs,
    feed_controllers,
    step_inputs,
)
from waveverify_torch.train.state import create_train_state
from waveverify_torch.train.step import train_step, train_steps
from waveverify_torch.weights import export_params

torch.set_num_threads(2)

B, T = 4, 3200
DISC = {2: [True, False], 3: [True, False, True]}
# the metrics JAX's step reports that the dispatch stacks, per step
CHECKED = ["loss", "stft/loss", "mel/loss", "waveform/loss", "adv/gen_loss",
           "adv/feat_loss", "dec/loss", "loc/loss", "adv/disc_loss",
           "grad_norm/generator", "grad_norm/discriminator", "train/ber",
           "train/miou"]


def _batches(k):
    rng = np.random.RandomState(10 + k)
    audios = (rng.randn(k, B, T) * 0.1).astype(np.float32)
    msgs = rng.randint(0, 2, (k, B, 16)).astype(np.float32)
    idxs = np.stack([rng.permutation(len(BANK))[:B] for _ in range(k)]).astype(np.int32)
    return audios, msgs, idxs


def _fresh(tcfg):
    return create_train_state(tcfg, torch.Generator().manual_seed(0),
                              torch.device("cpu"))


def run_dispatch(k):
    """JAX's K-step program and the port's ``train_steps`` from the same
    parameters, batches and per-step draws (step j draws under
    ``fold_in(KEY, j)``, as the scanned step folds its step count), with the
    disc vector ``DISC[k]``; and how far each of the port's metrics moves
    when the audio is scaled by 1 +- 1e-7 (its f32 noise floor: after the
    first step, parameters that part within 2 lr feed the gradient
    penalty and the log-STFT features, which amplify it)."""
    jcfg, tcfg = tiny_configs(B, remat=False)
    jmodels = JModels.from_config(jcfg)
    wm, disc = jax_params(_fresh(tcfg).models)
    wm_tx, disc_tx = make_optimizers(jcfg.optim)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), wm_params=wm,
                         disc_params=disc, wm_opt_state=wm_tx.init(wm),
                         disc_opt_state=disc_tx.init(disc))
    audios, msgs, idxs = _batches(k)
    multi = jax.jit(make_multi_train_step(jmodels, jcfg, JBank(BANK), k))
    jnew, jm = multi(jstate, audios, msgs, idxs, KEY, None,
                     np.asarray(DISC[k], np.bool_))
    draws = [jax_draws(KEY, j, B, T, BANK) for j in range(k)]
    runs = {}
    for e in (0.0, 1e-7, -1e-7):
        state = _fresh(tcfg)
        tm = train_steps(state, tcfg, EffectBank(BANK),
                         torch.from_numpy(audios) * (1 + e), torch.from_numpy(msgs),
                         list(idxs), draws, train_disc=DISC[k])
        runs[e] = (state, tm)
    state, tm = runs[0.0]
    spread = {name: [max(_rel(runs[e][1][name][j], tm[name][j]) for e in (1e-7, -1e-7))
                     for j in range(k)] for name in CHECKED}
    return dict(tcfg=tcfg, jnew=jnew, jm=jm, state=state, tm=tm, draws=draws,
                spread=spread)


def check_losses(r, k, name):
    """Each step's loss or norm on the ``[K]`` axis against JAX's, within
    1e-4 or three times the port's own noise floor at that step, whichever
    is larger; the adversarial ones 0 on a step without the discriminator,
    in both packages."""
    jm, tm = r["jm"], r["tm"]
    assert tm[name].shape == (k,)
    for j in range(k):
        if name in ("adv/gen_loss", "adv/disc_loss", "grad_norm/discriminator") \
                and not DISC[k][j]:
            assert float(tm[name][j]) == float(jm[name][j]) == 0.0
            continue
        tol = max(1e-4, 3 * r["spread"][name][j])
        assert _rel(tm[name][j], jm[name][j]) <= tol, (
            j, float(tm[name][j]), float(jm[name][j]), tol)


def check_feedback(r, k):
    """The per-sample and per-bit feedback stacked ``[K, ...]``: BER and
    per-bit accuracy count thresholded decisions, so one sample or bit may
    flip where the random-init networks sit at the threshold."""
    jm, tm = r["jm"], r["tm"]
    assert tm["per_sample_ber"].shape == (k, B)
    assert tm["per_bit_acc"].shape == (k, 16)
    for name, tol in (("per_sample_ber", 1 / 16), ("per_sample_miou", 1e-3),
                      ("per_bit_acc", 1 / B)):
        dev = np.abs(tm[name].numpy() - np.asarray(jm[name]))
        assert dev.max() <= tol + 1e-6, (name, dev.max())


def check_params(r, k):
    """After K Adam steps a parameter moves about lr a step, so two sides
    that round a gradient's sign apart part by at most 2 lr a step."""
    jnew, state = r["jnew"], r["state"]
    for net in NETS:
        ours = export_params(getattr(state.models, net), net)
        tree = jnew.disc_params if net == "discriminator" else jnew.wm_params[net]
        ref = {f"{net}/{key}": np.asarray(v) for key, v in _flatten(tree).items()}
        assert set(ours) == set(ref)
        worst = max(float(np.abs(ours[key] - ref[key]).max()) for key in ours)
        assert worst <= 2e-4 * k, (net, worst)
    assert state.step == int(jnew.step) == k


@pytest.fixture(scope="module")
def k2():
    return run_dispatch(2)


@pytest.mark.parametrize("name", CHECKED)
def test_dispatch_losses_match_jax(k2, name):
    check_losses(k2, 2, name)


def test_dispatch_feedback_matches_jax(k2):
    check_feedback(k2, 2)


def test_dispatch_params_within_2lr_per_step(k2):
    check_params(k2, 2)


def test_dispatch_equals_single_steps(k2):
    """``train_steps`` is K port steps: the same metrics, bit for bit, and
    the same parameters."""
    k = 2
    tcfg, state, tm, draws = k2["tcfg"], k2["state"], k2["tm"], k2["draws"]
    audios, msgs, idxs = _batches(k)
    single = _fresh(tcfg)
    steps = [train_step(single, tcfg, EffectBank(BANK), torch.from_numpy(audios[j]),
                        torch.from_numpy(msgs[j]), idxs[j], draws[j],
                        train_disc=DISC[k][j]) for j in range(k)]
    for name, v in tm.items():
        torch.testing.assert_close(v, torch.stack([m[name] for m in steps]),
                                   rtol=0, atol=0, msg=name)
    for (n, p), q in zip(state.models.named_parameters(), single.models.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


# the r5 recipe's controller knobs (scripts/train_demo_r5.sh), disc_every 3
R5 = dict(warmup_steps=25000, warmup_init_scale=0.01, warmup_ber_gate=0.2,
          warmup_fx_gate=0.12, warmup_msg_freeze_gate=0.3, warmup_msg_refreeze=True,
          warmup_nbits_start=4, warmup_nbits_gate=0.1, warmup_alt_period=8,
          warmup_alt_gen_frac=0.25, warmup_disc_every=3)


def _controllers():
    lc = dataclasses.replace(LossConfig(), **R5)
    args = (lc.warmup_steps, lc.warmup_init_scale, lc.warmup_ber_gate)
    kw = dict(fx_gate=lc.warmup_fx_gate, msg_freeze_gate=lc.warmup_msg_freeze_gate,
              msg_refreeze=lc.warmup_msg_refreeze, nbits=16)
    curr_args = (16, lc.warmup_nbits_start, lc.warmup_nbits_gate)
    return (lc, BerGatedRamp(*args, **kw), NbitsCurriculum(*curr_args),
            JRamp(*args, **kw), JCurriculum(*curr_args))


@pytest.mark.parametrize("progress", [0.0, 0.25])
@pytest.mark.parametrize("k", [2, 4])
def test_dispatch_inputs_follow_the_jax_loop(progress, k):
    """The disc vector is the JAX loop's ``[ramp.progress > 0 or (step + j)
    % disc_every == 0 for j in range(K)]``; the other inputs are the first
    step's, held: the percep scale, the alternation's generator flag
    (``step % period >= period - gen_steps`` at the dispatch's start), the
    message freeze and the bit mask."""
    lc, ramp, curr, _, _ = _controllers()
    ramp.fx_latched, ramp.progress = True, progress
    period = lc.warmup_alt_period
    gen_steps = max(1, int(period * lc.warmup_alt_gen_frac))
    for step in range(0, 24, k):
        inputs, disc = dispatch_inputs(step, k, ramp, curr, lc)
        assert disc == [ramp.progress > 0.0 or (step + j) % lc.warmup_disc_every == 0
                        for j in range(k)], step
        held = step_inputs(step, ramp, curr, lc)
        for field in ("percep_scale", "train_disc", "gen_update_scale",
                      "msg_update_scale", "fx_on"):
            assert getattr(inputs, field) == getattr(held, field), field
        gen_on = ramp.progress > 0.0 or step % period >= period - gen_steps
        assert inputs.gen_update_scale == (1.0 if gen_on else 0.0)
        assert inputs.percep_scale == ramp.scale()
        np.testing.assert_array_equal(inputs.bit_mask, curr.mask())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_feedback_per_dispatch_follows_the_jax_loop(k):
    """One feedback per dispatch, one dispatch late, as the JAX loop feeds
    it: ``per_bit_acc`` averaged over axis 0, the active bits' BER (the
    curriculum is on), ``ramp.update(k=K)``; over 3000 seeded dispatches
    the port's and the JAX classes' states stay equal."""
    lc, ramp, curr, jramp, jcurr = _controllers()
    rng = np.random.RandomState(k)
    for i in range(3000):
        # accuracy drifting up, so every latch and the curriculum move
        acc = np.clip(rng.rand(k, 16) * 0.5 + 0.45 + i / 3000, 0, 1).astype(np.float32)
        ber = (1 - acc.mean(axis=1)).astype(np.float32)
        feed_controllers(ramp, curr, ber if k > 1 else ber[0],
                         acc if k > 1 else acc[0], k=k)
        jacc = np.asarray(acc if k > 1 else acc[0])
        jacc = jacc.mean(axis=0) if jacc.ndim == 2 else jacc
        jcurr.update(jacc)
        jramp.update(1.0 - float(jacc[: jcurr.n_active].mean()), k=k,
                     per_bit_acc=jacc, n_active=jcurr.n_active)
        assert ramp.state_dict() == jramp.state_dict(), i
        assert curr.state_dict() == jcurr.state_dict(), i
    assert ramp.progress > 0 and curr.n_active == 16 and ramp.msg_on()
