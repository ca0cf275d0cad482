"""The port's training controllers against the JAX package's, on the CPU:
``BerGatedRamp`` and ``NbitsCurriculum`` fed one seeded sequence of
per-step feedback (state for state, every step), the r5 snapshot's meta
restored into both, and the per-step inputs the loop hands the train step
(the discriminator's cadence, the alternation, the step-indexed ramp, the
latches)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from waveverify_tpu.effects.effects_config import load_effects_config as jload_effects
from waveverify_tpu.effects.scheduler import EffectScheduler as JScheduler
from waveverify_tpu.train.loop import BerGatedRamp as JRamp
from waveverify_tpu.train.loop import NbitsCurriculum as JCurriculum
from waveverify_torch.config import LossConfig, load_config
from waveverify_torch.effects.effects_config import load_effects_config
from waveverify_torch.effects.scheduler import EffectScheduler
from waveverify_torch.train.loop import (
    BerGatedRamp,
    NbitsCurriculum,
    feed_controllers,
    make_controllers,
    step_inputs,
)
from waveverify_torch.train.step import step_ramp

R5_META = "weights/snapshots/demo_r5_latest_meta.json"
# LossConfig.warmup_* of scripts/train_demo_r5.sh's --set flags
R5_WARMUP = dict(steps=6000, init_scale=0.01, ber_gate=0.10, fx_gate=0.12,
                 disc_every=4, alt_period=800, alt_gen_frac=0.25,
                 msg_freeze_gate=0.3, msg_refreeze=True, nbits_start=4,
                 nbits_gate=0.02)
# gate settings of the sequence test: the r5 recipe's; the ramp alone, fed
# the all-bit BER; every latch but the message freeze, with a 2-bit start
SETTINGS = {
    "r5": R5_WARMUP,
    "ramp_only": dict(steps=500, init_scale=0.1, ber_gate=0.2),
    "refreeze_2bit": dict(steps=1000, init_scale=0.01, ber_gate=0.15,
                          fx_gate=0.3, msg_refreeze=True, nbits_start=2,
                          nbits_gate=0.05),
}
N_UPDATES = 7000
NBITS = 16


def _cfg(warmup):
    return load_config(None, {f"warmup.{k}": v for k, v in warmup.items()})


def _jax_controllers(lc):
    """The JAX loop's construction of its controllers (loop.py:516-530)."""
    if lc.warmup_ber_gate <= 0:
        return None, None
    ramp = JRamp(lc.warmup_steps, lc.warmup_init_scale, lc.warmup_ber_gate,
                 fx_gate=lc.warmup_fx_gate,
                 msg_freeze_gate=lc.warmup_msg_freeze_gate,
                 msg_refreeze=lc.warmup_msg_refreeze, nbits=NBITS)
    curr = None
    if lc.warmup_nbits_start > 0:
        curr = JCurriculum(NBITS, lc.warmup_nbits_start, lc.warmup_nbits_gate)
    return ramp, curr


def _jax_feed(ramp, curr, train_ber, per_bit_acc):
    """The JAX loop's feedback of one step (loop.py:848-862, K = 1)."""
    acc = np.asarray(per_bit_acc)
    if curr is not None:
        curr.update(acc)
        gate_ber = 1.0 - float(acc[: curr.n_active].mean())
    else:
        gate_ber = float(np.mean(np.asarray(train_ber)))
    if ramp is not None:
        ramp.update(gate_ber, k=1, per_bit_acc=acc,
                    n_active=(curr.n_active if curr is not None else None))


def _feedback_sequence(seed=0):
    """Per-step (train/ber, per-bit accuracy) as a batch of 16 would give
    them (float32, accuracy in sixteenths): bits 0-3 learn from step 0,
    bits 4-7 from step 250, the rest from step 500, each from chance to
    0.99 in 400 steps; from step 1500 to 1900 bit 2 falls to 0.1 (the
    lockstep signature), then recovers."""
    rng = np.random.RandomState(seed)
    start = np.array([0] * 4 + [250] * 4 + [500] * 8)
    for t in range(N_UPDATES):
        level = 0.5 + 0.49 * np.clip((t - start) / 400.0, 0.0, 1.0)
        if 1500 <= t < 1900:
            level[2] = 0.1
        acc = np.clip(level + rng.randn(NBITS) * 0.03, 0.0, 1.0)
        acc = (np.round(acc * 16) / 16).astype(np.float32)
        ber = np.float32(np.clip(1.0 - acc.mean() + rng.randn() * 0.01, 0.0, 1.0))
        yield ber, acc


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_controllers_match_jax_over_a_sequence(setting):
    lc = _cfg(SETTINGS[setting]).loss
    ramp, curr = make_controllers(_cfg(SETTINGS[setting]))
    jramp, jcurr = _jax_controllers(lc)
    assert (curr is None) == (jcurr is None)
    seen = set()
    n_active = [curr.n_active] if curr is not None else []
    for i, (ber, acc) in enumerate(_feedback_sequence()):
        before = ramp.state_dict()
        feed_controllers(ramp, curr, ber, acc)
        _jax_feed(jramp, jcurr, ber, acc)
        assert ramp.state_dict() == jramp.state_dict(), i
        assert ramp.scale() == jramp.scale(), i
        assert (ramp.msg_on(), ramp.attacks_on()) == (jramp.msg_on(), jramp.attacks_on())
        if curr is not None:
            assert curr.state_dict() == jcurr.state_dict(), i
            np.testing.assert_array_equal(curr.mask(), jcurr.mask())
            if curr.n_active != n_active[-1]:
                n_active.append(curr.n_active)
        for key, name in (("fx_latched", "fx latch"), ("msg_latched", "msg latch")):
            if ramp.state_dict()[key] > before[key]:
                seen.add(name)
        if ramp.msg_refrozen and not before["msg_refrozen"]:
            seen.add("re-freeze")
        if before["msg_refrozen"] and not ramp.msg_refrozen:
            seen.add("thaw")
        if ramp.progress == 1.0:
            seen.add("progress 1")
    w = SETTINGS[setting]
    expected = {"progress 1"}
    if w.get("fx_gate", 0) > 0:
        expected.add("fx latch")
    if w.get("msg_freeze_gate", 0) > 0:
        expected.add("msg latch")
    if w.get("msg_refreeze"):
        expected |= {"re-freeze", "thaw"}
    assert seen == expected
    if setting == "r5":
        assert n_active == [4, 8, 16]
    elif curr is not None:
        assert n_active == [2, 4, 8, 16]


def _r5_schedulers():
    ours = EffectScheduler(load_effects_config("conf/effects_config.yml")
                           .effect_param_grid, rng=np.random.RandomState(1))
    ref = JScheduler(jload_effects("conf/effects_config.yml").effect_param_grid,
                     rng=np.random.RandomState(1))
    return ours, ref


@pytest.mark.parametrize("part", ["ramp", "curriculum", "scheduler"])
def test_r5_snapshot_restores_equal_to_jax(part):
    """The r5 snapshot's meta (step 11000) restores the same controller and
    scheduler states in both packages; its ramp gives the perceptual scale
    the JAX run logged on every line from step 8249 to 11099."""
    meta = json.loads(open(R5_META).read())
    cfg = _cfg(R5_WARMUP)
    ramp, curr = make_controllers(cfg)
    jramp, jcurr = _jax_controllers(cfg.loss)
    if part == "ramp":
        ramp.load_state_dict(meta["ramp_state"])
        jramp.load_state_dict(meta["ramp_state"])
        assert ramp.state_dict() == jramp.state_dict() == {
            k: meta["ramp_state"][k] for k in ramp.state_dict()}
        assert ramp.scale() == jramp.scale() == 0.015357952969989128
        assert ramp.attacks_on() and ramp.msg_on()
    elif part == "curriculum":
        curr.load_state_dict(meta["nbits_state"])
        jcurr.load_state_dict(meta["nbits_state"])
        assert curr.state_dict() == jcurr.state_dict() == meta["nbits_state"]
        assert curr.n_active == 16 and curr.mask().sum() == 16
    else:
        ours, ref = _r5_schedulers()
        ours.load_state_dict(meta["scheduler_state"])
        ref.load_state_dict(meta["scheduler_state"])
        assert ours.state_dict() == ref.state_dict()


def _ramp(progress=0.0, **warmup):
    cfg = _cfg(dict(R5_WARMUP, **warmup))
    ramp, curr = make_controllers(cfg)
    ramp.progress = progress
    return cfg.loss, ramp, curr


@pytest.mark.parametrize("case", ["cadence", "alternation", "recipe_period",
                                  "no_ramp", "latches"])
def test_step_inputs_follow_the_jax_loop(case):
    """The per-step inputs of loop.py:732-790: the discriminator every
    disc_every-th step until the ramp moves, the alternation's
    [0] * (period - gen_steps) + [1] * gen_steps per period, no scale
    (the step's own step-indexed ramp) and no cadence or alternation
    without the ramp,
    and the closed latches of a fresh ramp."""
    steps = range(32)
    if case == "cadence":
        lc, ramp, curr = _ramp()
        assert [step_inputs(s, ramp, curr, lc).train_disc for s in steps] == [
            s % 4 == 0 for s in steps]
        lc, ramp, curr = _ramp(progress=1e-4)
        assert all(step_inputs(s, ramp, curr, lc).train_disc for s in steps)
    elif case == "alternation":
        lc, ramp, curr = _ramp(alt_period=8)
        got = [step_inputs(s, ramp, curr, lc) for s in steps]
        assert [x.gen_update_scale for x in got] == ([0.0] * 6 + [1.0] * 2) * 4
        lc, ramp, curr = _ramp(progress=0.5, alt_period=8)
        assert all(step_inputs(s, ramp, curr, lc).gen_update_scale == 1.0
                   for s in steps)
    elif case == "recipe_period":
        lc, ramp, curr = _ramp(alt_period=800, alt_gen_frac=0.25)
        on = [step_inputs(s, ramp, curr, lc).gen_update_scale for s in range(1600)]
        assert on == ([0.0] * 600 + [1.0] * 200) * 2
    elif case == "no_ramp":
        lc = LossConfig(warmup_steps=6000, warmup_disc_every=4,
                        warmup_alt_period=8)
        for s in [0, 1, 100, 3000, 5999, 6000, 7000]:
            x = step_inputs(s, None, None, lc)
            ref = float(lc.warmup_init_scale ** (
                1.0 - jnp.clip(jnp.asarray(s, jnp.float32) / lc.warmup_steps,
                               0.0, 1.0)))
            got = step_ramp(s, lc)
            assert abs(got - ref) <= 1e-6 * ref, (s, got, ref)
            assert (x.percep_scale, x.train_disc, x.gen_update_scale,
                    x.msg_update_scale, x.bit_mask, x.fx_on) == (
                        None, True, 1.0, 1.0, None, True)
        assert step_ramp(5, LossConfig()) == 1.0
    else:
        lc, ramp, curr = _ramp()
        x = step_inputs(0, ramp, curr, lc)
        assert (x.percep_scale, x.msg_update_scale, x.fx_on) == (0.0, 0.0, False)
        np.testing.assert_array_equal(x.bit_mask, [1] * 4 + [0] * 12)
        ramp.load_state_dict(json.loads(open(R5_META).read())["ramp_state"])
        x = step_inputs(11000, ramp, curr, lc)
        assert (x.percep_scale, x.msg_update_scale, x.fx_on, x.train_disc) == (
            0.015357952969989128, 1.0, True, True)
