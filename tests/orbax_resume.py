"""``--resume`` from the JAX trainer's orbax checkpoints, on the CPU: the
cases and their checks. ``tests/test_torch_orbax_resume.py`` (the plain
layout and the params-only case, one JAX compile) and
``tests/test_torch_orbax_resume_multi.py`` (the ``multi_transform``, the
other compile) import the checks, so that two workers compile the two JAX
steps side by side.

Each case writes a JAX TrainState one JAX step after the port's seed-0
initialisation (so its moments are non-zero and its update and schedule
counts are 1) with the JAX package's ``save_checkpoint``, then resumes it
in both packages and takes one more step on the same inputs and draws:
JAX's ``load_checkpoint`` (and, where the optimizer structure changed,
its loop's params-only fallback, ``waveverify_tpu/train/loop.py``) and
``make_train_step``; the port's ``load_checkpoint`` and ``train_step``.
The cases: the plain ``adamw`` chain, the ``multi_transform`` of the r5
recipe's learning-rate multipliers, and a multi_transform checkpoint (the
plain step's parameters beside a fresh multi_transform state) resumed
under the plain config, where JAX starts the optimizer fresh.

Held, after the resumed step: the step count; the losses (rel 1e-4, as
``tests/test_torch_train.py``); every gradient leaf, JAX's recovered from
its new first moment (``g = (mu' - b1 mu) / (1 - b1)``), and every first
and second moment, each by the relative norm of port - JAX with
``tests/train_parity.py``'s leaf floor, to ``GRAD_TOL`` or three times the
port's own spread where that is larger (its worst leaf when the audio of
the resumed step moves by 1 +- 1e-7 relative, as the step tests hold the
gradient norms: at this state the generator's FiLM biases move by up to
3.6e-2 there, against a ``GRAD_TOL`` of 2e-2); the parameters within 2 lr
of the network, as the first step's; and the learning rates the step
used. A moment or count that did not carry across is off by order one.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import BANK, GRAD_TOL, KEY, export_grads
from tests.torch_jax_bridge import jax_draws, jax_params, tiny_configs
from tests.train_parity import worst_leaf
from waveverify_tpu import config as jconfig
from waveverify_tpu.effects.effects import EffectBank as JBank
from waveverify_tpu.train import checkpoint as jckpt
from waveverify_tpu.train.state import TrainState as JTrainState
from waveverify_tpu.train.state import make_optimizers
from waveverify_tpu.train.step import make_train_step
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_torch import config as tconfig
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.train import checkpoint as ckpt
from waveverify_torch.train.state import create_train_state
from waveverify_torch.train.step import train_step
from waveverify_torch.weights import export_params

B, T = 4, 3200
NETS = ("generator", "detector", "locator", "discriminator")
MULT = dict(detector_lr_mult=10.0, generator_lr_mult=2.0)  # the r5 recipe's
LOSSES = ["loss", "stft/loss", "mel/loss", "waveform/loss", "adv/gen_loss",
          "adv/feat_loss", "dec/loss", "loc/loss", "adv/disc_loss"]
# case -> (layout the checkpoint has, layout the resuming config builds);
# True is the multi_transform
CASES = {"plain": (False, False), "multi_transform": (True, True),
         "params_only": (True, False)}
__all__ = ["CASES", "resume_case", "test_resume_takes_the_layout_as_jax_does",
           "test_resumed_learning_rates_are_jax_schedules",
           "test_resumed_step_losses_match_jax",
           "test_resumed_step_moments_and_gradients_match_jax",
           "test_resumed_step_params_within_2lr"]


def _configs(multi):
    """(JAX, port) tiny configs: the MRD alone, the multipliers if ``multi``."""
    out = []
    for mod, cfg in zip((jconfig, tconfig), tiny_configs(B, remat=False)):
        optim = dataclasses.replace(cfg.optim, **(MULT if multi else {}))
        out.append(dataclasses.replace(
            cfg, optim=optim,
            discriminator=mod.DiscriminatorConfig(periods=(), fft_sizes=(256,))))
    return tuple(out)


def _inputs(i):
    rng = np.random.RandomState(10 + i)
    audio = (rng.randn(B, T) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (B, 16)).astype(np.float32)
    return audio, msg, np.array([0, 1, 2, 3], np.int32)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _fresh(multi):
    """The port's seed-0 state and the same parameters as a fresh JAX
    TrainState, in the layout ``multi``."""
    jcfg, tcfg = _configs(multi)
    state = create_train_state(tcfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    wm, disc = jax_params(state.models)
    wm_tx, disc_tx = make_optimizers(jcfg.optim)
    return state, JTrainState(step=jnp.zeros((), jnp.int32), wm_params=wm,
                              disc_params=disc, wm_opt_state=wm_tx.init(wm),
                              disc_opt_state=disc_tx.init(disc))


def _jax_resume(root, template):
    """JAX's resume of ``root/latest`` (``train/loop.py``'s code); returns
    (state, whether the optimizer state was restored)."""
    try:
        state, _ = jckpt.load_checkpoint(str(root), "latest", template)
        return state, True
    except ValueError:
        raw, _ = jckpt.load_state_free(str(root), "latest")

        def cast(t, loaded):
            return jax.tree_util.tree_map(
                lambda init, new: jnp.asarray(new, init.dtype).reshape(init.shape),
                t, loaded)

        return template.replace(
            wm_params=cast(template.wm_params, raw["wm_params"]),
            disc_params=cast(template.disc_params, raw["disc_params"]),
            step=jnp.asarray(raw["step"], template.step.dtype)), False


def _adam(opt_state, multi, net):
    """(count, mu, nu, schedule count) of ``net`` in a live optax state."""
    if net == "discriminator":
        chain, sub = opt_state, None
    elif multi:
        chain, sub = opt_state.inner_states[net].inner_state, net
    else:
        chain, sub = opt_state, net
    adam, sched = chain[0], chain[2]
    pick = (lambda t: t[sub]) if sub else (lambda t: t)
    return int(adam.count), pick(adam.mu), pick(adam.nu), int(sched.count)


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _port_step(root, multi, scale=1.0):
    """The port's resume of ``root/latest`` and one step on the resumed
    step's audio * ``scale``; returns (state, metrics, meta, learning
    rates before the step, warnings)."""
    _, tcfg = _configs(multi)
    port, _ = _fresh(multi)
    log, handler = logging.getLogger("waveverify_torch.train.checkpoint"), _Warnings()
    log.addHandler(handler)
    try:
        meta = ckpt.load_checkpoint(root, "latest", port, tcfg)
    finally:
        log.removeHandler(handler)
    lrs = {g.get("name", "discriminator"): g["lr"]
           for opt in (port.wm_opt, port.disc_opt) for g in opt.param_groups}
    audio, msg, idx = _inputs(1)
    tm = train_step(port, tcfg, EffectBank(BANK), torch.from_numpy(audio) * scale,
                    torch.from_numpy(msg), idx, jax_draws(KEY, port.step, B, T, BANK))
    return port, tm, meta, lrs, handler.messages


def _grads(port, net):
    return {f"{net}/{k}": g for k, g in export_grads(getattr(port.models, net)).items()}


def compile_step(multi):
    """JAX's jitted train step of the layout ``multi``."""
    jcfg, _ = _configs(multi)
    return jax.jit(make_train_step(JModels.from_config(jcfg), jcfg, JBank(BANK)))


def resume_case(case, steps, root):
    """Write, resume and step ``case`` in both packages (``steps``: the
    compiled JAX step of each layout the case needs, by ``multi``)."""
    written, multi = CASES[case]
    _, s0 = _fresh(written and multi)
    s1, _ = steps[written and multi](s0, *_inputs(0), KEY)
    if written and not multi:  # the plain step's parameters, a fresh multi state
        wm_tx, _ = make_optimizers(_configs(True)[0].optim)
        s1 = s1.replace(wm_opt_state=wm_tx.init(s1.wm_params))
    jckpt.save_checkpoint(str(root), "latest", s1, {"step": 1})

    _, template = _fresh(multi)
    jstate, full = _jax_resume(root, template)
    jnew, jm = steps[multi](jstate, *_inputs(1), KEY)

    port, tm, meta, lrs, warnings = _port_step(root, multi)
    spread = {net: 0.0 for net in NETS}
    for scale in (1 + 1e-7, 1 - 1e-7):
        moved = _port_step(root, multi, scale)[0]
        for net in NETS:
            spread[net] = max(spread[net], worst_leaf(_grads(moved, net),
                                                      _grads(port, net))[1])
    return dict(case=case, multi=multi, full=full, warnings=warnings, meta=meta,
                jstate=jstate, jnew=jnew, jm=jm, port=port, tm=tm, lrs=lrs,
                spread=spread, tcfg=_configs(multi)[1])


def test_resume_takes_the_layout_as_jax_does(resumed):
    """The optimizer state carries across exactly where JAX's restore
    takes it; the params-only case warns, as the JAX loop does."""
    params_only = resumed["case"] == "params_only"
    assert resumed["full"] == (not params_only)
    assert any("params-only" in m for m in resumed["warnings"]) == params_only
    assert resumed["meta"] == {"step": 1}
    assert resumed["port"].step == int(resumed["jnew"].step) == 2


def _mult(optim, net):
    return {"generator": optim.generator_lr_mult,
            "detector": optim.detector_lr_mult}.get(net, 1.0)


def test_resumed_learning_rates_are_jax_schedules(resumed):
    """Each group's rate in the resumed step: lr * mult * gamma^count,
    optax's ``exponential_decay`` at the restored schedule count (0 when
    the optimizer starts fresh)."""
    optim, jstate = resumed["tcfg"].optim, resumed["jstate"]
    for name, lr in resumed["lrs"].items():
        net = name.split("/")[0]
        opt = jstate.disc_opt_state if net == "discriminator" else jstate.wm_opt_state
        t = _adam(opt, resumed["multi"], net)[3]
        assert t == (1 if resumed["full"] else 0)
        assert lr == pytest.approx(optim.lr * _mult(optim, net) * optim.exp_gamma ** t,
                                   rel=1e-7)


@pytest.mark.parametrize("name", LOSSES)
def test_resumed_step_losses_match_jax(resumed, name):
    got, ref = float(resumed["tm"][name]), float(resumed["jm"][name])
    assert abs(got - ref) <= 1e-4 * max(abs(ref), 1e-12), (name, got, ref)


def _jax_moments(resumed, net):
    """JAX's (count, mu', nu', gradient) of ``net`` after the step, the
    gradient recovered from the first moment's update."""
    b1 = resumed["tcfg"].optim.beta1
    field = "disc_opt_state" if net == "discriminator" else "wm_opt_state"
    _, mu0, _, _ = _adam(getattr(resumed["jstate"], field), resumed["multi"], net)
    count, mu, nu, _ = _adam(getattr(resumed["jnew"], field), resumed["multi"], net)
    mu0, mu, nu = _flat(mu0, net), _flat(mu, net), _flat(nu, net)
    grad = {k: (mu[k].astype(np.float64) - b1 * mu0[k]) / (1 - b1) for k in mu}
    return count, mu, nu, grad


def _port_moments(port, net):
    """(AdamW's step counts, exp_avg, exp_avg_sq) of ``net`` in flax paths
    and layouts."""
    module = getattr(port.models, net)
    opt = port.disc_opt if net == "discriminator" else port.wm_opt
    saved = {n: p.detach().clone() for n, p in module.named_parameters()}
    out = {}
    for key in ("exp_avg", "exp_avg_sq"):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(opt.state[p][key])
        out[key] = export_params(module, net)
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(saved[n])
    steps = {int(opt.state[p]["step"]) for p in module.parameters()}
    return steps, out["exp_avg"], out["exp_avg_sq"]


@pytest.mark.parametrize("net", NETS)
def test_resumed_step_moments_and_gradients_match_jax(resumed, net):
    count, mu, nu, grad = _jax_moments(resumed, net)
    steps, m, v = _port_moments(resumed["port"], net)
    assert steps == {count} == {2 if resumed["full"] else 1}
    limit = max(GRAD_TOL[net], 3 * resumed["spread"][net])
    for what, ours, ref in (("grad", _grads(resumed["port"], net), grad),
                            ("mu", m, mu), ("nu", v, nu)):
        leaf, dev = worst_leaf(ours, ref)
        assert dev <= limit, (what, leaf, dev, resumed["spread"][net])


@pytest.mark.parametrize("net", NETS)
def test_resumed_step_params_within_2lr(resumed, net):
    """The parameters after the step, held as ``tests/test_torch_train.py``
    holds the first step's: Adam moves a parameter whose gradient the two
    sides round apart by at most 2 lr (the network's, multiplier included;
    the moments above are the sharp check of what carried across)."""
    jnew = resumed["jnew"]
    ref = _flat(jnew.disc_params if net == "discriminator" else jnew.wm_params[net], net)
    ours = export_params(getattr(resumed["port"].models, net), net)
    assert set(ours) == set(ref)
    worst = max(float(np.abs(ours[k] - ref[k]).max()) for k in ref)
    optim = resumed["tcfg"].optim
    assert worst <= 2 * optim.lr * _mult(optim, net), worst
