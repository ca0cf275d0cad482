"""The split step (``disc_step``, then ``train_step(update_disc=False)``)
against the JAX package's (``make_disc_step``, then
``make_train_step(update_disc=False)``), f32 on the CPU at the tiny
configuration, ungated and under two gate settings: the losses and the
parameters within 2 lr; and within the port, the split step against the
monolithic step. Every gradient leaf against ``jax.grad`` is in
``test_torch_split_disc_grads.py`` (a file of its own, so that the JAX
compiles of the two files run on two workers).

The JAX split feeds its discriminator ``apply_generator(audio, msg)``, the
monolithic step ``outs["residual"]``: the same generator output, since
``sub_hop_jitter`` and ``window_duration`` act only after it. So the split
step computes the monolithic step in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import (
    BANK,
    KEY,
    LOSSES,
    NETS,
    _flatten,
    _inputs,
    _rel,
)
from tests.torch_jax_bridge import jax_draws, jax_params, tiny_configs
from waveverify_tpu.effects.effects import EffectBank as JBank
from waveverify_tpu.train.state import TrainState as JTrainState
from waveverify_tpu.train.state import make_optimizers
from waveverify_tpu.train.step import make_disc_step, make_train_step
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.train.state import create_train_state
from waveverify_torch.train.step import disc_step, train_step
from waveverify_torch.weights import export_params

torch.set_num_threads(2)

B, T = 4, 3200
# the controllers' inputs: neutral (the ungated step); the discriminator on
# with the message path frozen; the discriminator off (the loop then runs
# no disc_step, and the generator's adversarial terms are 0)
GATES = {
    "ungated": None,
    "disc_on_msg_frozen": dict(percep_scale=0.015357952969989128,
                               train_disc=True, gen_update_scale=1.0,
                               msg_update_scale=0.0, n_bits=4),
    "disc_off": dict(percep_scale=0.3, train_disc=False, gen_update_scale=1.0,
                     msg_update_scale=1.0, n_bits=8),
}
NEUTRAL = dict(percep_scale=1.0, train_disc=True, gen_update_scale=1.0,
               msg_update_scale=1.0, n_bits=16)


def _fresh(tcfg):
    return create_train_state(tcfg, torch.Generator().manual_seed(0),
                              torch.device("cpu"))


def _port_split(tcfg, gate, audio, msg, idx):
    """The port's split step, as the loop runs it: ``disc_step`` only where
    the discriminator trains."""
    state = _fresh(tcfg)
    d = jax_draws(KEY, 0, B, T, BANK)
    a, m = torch.from_numpy(audio), torch.from_numpy(msg)
    kw = {}
    if gate is not None:
        kw = {k: v for k, v in gate.items() if k != "n_bits"}
        kw["bit_mask"] = torch.from_numpy(
            (np.arange(16) < gate["n_bits"]).astype(np.float32))
    dm = disc_step(state, tcfg, a, m, d) if kw.get("train_disc", True) else {}
    tm = train_step(state, tcfg, EffectBank(BANK), a, m, idx, d,
                    update_disc=False, **kw)
    return state, {**tm, **dm}, kw


@pytest.fixture(scope="module")
def steps():
    """For each gate: the JAX split step and the port's, from the same
    parameters and draws, and the port's monolithic step."""
    jcfg, tcfg = tiny_configs(B, remat=False)
    init = _fresh(tcfg)
    jmodels = JModels.from_config(jcfg)
    wm, disc = jax_params(init.models)
    wm_tx, disc_tx = make_optimizers(jcfg.optim)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), wm_params=wm,
                         disc_params=disc, wm_opt_state=wm_tx.init(wm),
                         disc_opt_state=disc_tx.init(disc))
    audio, msg, idx = _inputs()
    # the disc program does not see the gates: one run serves both gates
    # that train the discriminator
    jdisc_state, jdm = jax.jit(make_disc_step(jmodels, jcfg))(jstate, audio,
                                                              msg, KEY)
    jgen = jax.jit(make_train_step(jmodels, jcfg, JBank(BANK), update_disc=False))
    out = {}
    for name, gate in GATES.items():
        g = gate or NEUTRAL
        js, dm = (jdisc_state, jdm) if g["train_disc"] else (jstate, {})
        mask = (np.arange(16) < g["n_bits"]).astype(np.float32)
        args = (js, audio, msg, idx, KEY, np.float32(g["percep_scale"]),
                np.bool_(g["train_disc"]), np.float32(g["gen_update_scale"]),
                np.float32(g["msg_update_scale"]), mask)
        jnew, jm = jgen(*args)
        state, tm, kw = _port_split(tcfg, gate, audio, msg, idx)
        mono = _fresh(tcfg)
        mm = train_step(mono, tcfg, EffectBank(BANK), torch.from_numpy(audio),
                        torch.from_numpy(msg), idx, jax_draws(KEY, 0, B, T, BANK),
                        **kw)
        out[name] = dict(jnew=jnew, jm={**jm, **dm}, state=state,
                         tm=tm, mono=mono, mm=mm)
    return jcfg, jmodels, jstate, out


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("name", LOSSES)
def test_split_step_losses_match_jax(steps, gate, name):
    r = steps[3][gate]
    assert _rel(r["tm"][name], r["jm"].get(name, 0.0)) <= 1e-4, (
        name, float(r["tm"][name]), float(r["jm"].get(name, 0.0)))


@pytest.mark.parametrize("gate", sorted(GATES))
def test_split_step_params_within_2lr(steps, gate):
    r = steps[3][gate]
    for net in NETS:
        ours = export_params(getattr(r["state"].models, net), net)
        tree = (r["jnew"].disc_params if net == "discriminator"
                else r["jnew"].wm_params[net])
        ref = {f"{net}/{k}": np.asarray(v) for k, v in _flatten(tree).items()}
        assert set(ours) == set(ref)
        worst = max(float(np.abs(ours[k] - ref[k]).max()) for k in ours)
        assert worst <= 2e-4, (net, worst)


@pytest.mark.parametrize("gate", sorted(GATES))
def test_split_step_equals_monolithic_step(steps, gate):
    """In the port the split step computes the monolithic step: the same
    losses and norms, gradients and parameters."""
    r = steps[3][gate]
    for k, v in r["mm"].items():
        torch.testing.assert_close(r["tm"][k], v, rtol=1e-6, atol=0, msg=k)
    for (n, p), q in zip(r["state"].models.named_parameters(),
                         r["mono"].models.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=0, msg=n)
        if q.grad is None:
            assert p.grad is None, n
        else:
            torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-12, msg=n)


def test_disc_step_moves_only_the_discriminator():
    """``disc_step`` updates the discriminator and its schedule, and leaves
    the three networks, their optimizer and the step count as they were."""
    _, tcfg = tiny_configs(B, remat=False)
    state = _fresh(tcfg)
    before = {n: p.detach().clone() for n, p in state.models.named_parameters()}
    audio, msg, _ = _inputs()
    m = disc_step(state, tcfg, torch.from_numpy(audio), torch.from_numpy(msg),
                  jax_draws(KEY, 0, B, T, BANK))
    assert set(m) == {"adv/disc_loss", "grad_norm/discriminator"}
    assert state.step == 0 and state.disc_sched.last_epoch == 1
    for n, p in state.models.named_parameters():
        assert torch.equal(p, before[n]) != n.startswith("discriminator."), n
