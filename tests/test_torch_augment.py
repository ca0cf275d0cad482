"""The port's training augmentations, effect bank, effect scheduler and
effects config against the JAX package's, fed the JAX key chain's draws;
and the training forward's clean, low-band and sub-hop-jitter paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_bridge import (
    jax_draws,
    jax_localization_draws,
    jax_params,
    jax_sequence_draws,
    tiny_configs,
)
from waveverify_tpu.effects import augment as jaug
from waveverify_tpu.effects.effects import DEFAULT_TRAIN_EFFECTS as J_TRAIN
from waveverify_tpu.effects.effects import EffectBank as JBank
from waveverify_tpu.effects.effects_config import load_effects_config as jload
from waveverify_tpu.effects.scheduler import EffectScheduler as JScheduler
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_tpu.train.watermarking import forward_train as jforward_train
from waveverify_torch.effects import augment as taug
from waveverify_torch.effects.effects import DEFAULT_TRAIN_EFFECTS, EffectBank
from waveverify_torch.effects.effects_config import load_effects_config
from waveverify_torch.effects.scheduler import EffectScheduler
from waveverify_torch.train.state import create_train_state
from waveverify_torch.train.watermarking import forward_train

torch.set_num_threads(2)


def _clips(b, t, seed=0):
    rng = np.random.RandomState(seed)
    orig = (rng.randn(b, t) * 0.1).astype(np.float32)
    wm = orig + (rng.randn(b, t) * 0.01).astype(np.float32)
    return orig, wm


@pytest.mark.parametrize("b,t,seed", [(4, 16000, 0), (3, 12345, 1), (1, 8000, 2),
                                      (8, 16000, 3)])
def test_localization_augmentation_exact(b, t, seed):
    orig, wm = _clips(b, t, seed)
    key = jax.random.PRNGKey(seed)
    ref = jaug.localization_augmentation(key, jnp.asarray(orig), jnp.asarray(wm))
    out = taug.localization_augmentation(torch.from_numpy(orig),
                                         torch.from_numpy(wm),
                                         *jax_localization_draws(key, b, t))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _key_for_branch(branch):
    """A key whose sequence draw takes ``branch``: 0 reverse, 1 shift,
    2 shuffle, 3 identity."""
    edges = [0.0, 0.3, 0.7, 1.0]
    for seed in range(200):
        u = float(jax.random.uniform(jax.random.split(jax.random.PRNGKey(seed), 3)[0], ()))
        if branch == 3:
            continue
        if edges[branch] <= u < edges[branch + 1]:
            return jax.random.PRNGKey(seed)
    raise AssertionError("no key found")


@pytest.mark.parametrize("branch,t", [(0, 16000), (1, 16000), (2, 16000),
                                      (2, 12000)])
def test_sequence_augmentation_exact(branch, t):
    b = 3
    orig, wm = _clips(b, t, 4)
    mask = (np.random.RandomState(5).rand(b, t) > 0.3).astype(np.float32)
    key = _key_for_branch(branch)
    ref = jaug.sequence_augmentation(key, jnp.asarray(wm), jnp.asarray(orig),
                                     jnp.asarray(mask))
    u, shift, perm = jax_sequence_draws(key, t)
    out = taug.sequence_augmentation(torch.from_numpy(wm), torch.from_numpy(orig),
                                     torch.from_numpy(mask), u, shift, perm)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_sequence_identity_branch():
    x = torch.arange(12.0).reshape(2, 6)
    out = taug.sequence_augmentation(x, x, x, 0.95, 3, torch.arange(1))
    for o in out:
        assert torch.equal(o, x)


def test_effect_bank_matches_jax_on_all_branches():
    """All 9 shipped branches, two samples each, with the JAX bank's own
    noise rows."""
    b, t = 18, 8000
    orig, wm = _clips(b, t, 6)
    mask = (np.random.RandomState(7).rand(b, t) > 0.2).astype(np.float32)
    idx = (np.arange(b) % 9).astype(np.int32)
    key = jax.random.PRNGKey(8)
    jbank, bank = JBank(J_TRAIN), EffectBank(DEFAULT_TRAIN_EFFECTS)
    assert bank.specs == jbank.specs
    ref_a, ref_m = jax.jit(jbank.apply)(jnp.asarray(wm), jnp.asarray(mask),
                                        jnp.asarray(idx), key)
    keys = jax.random.split(key, len(jbank))
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.normal(keys[i], (b, t)))
                                       for i in bank.noise_branches]))
    a, m = bank.apply(torch.from_numpy(wm), torch.from_numpy(mask), idx, noise)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))


def test_effect_bank_runs_each_branch_on_its_rows_only():
    bank = EffectBank(DEFAULT_TRAIN_EFFECTS)
    x = torch.randn(3, 4000, generator=torch.Generator().manual_seed(0))
    mask = torch.ones_like(x)
    noise = torch.randn(1, 3, 4000, generator=torch.Generator().manual_seed(1))
    a, _ = bank.apply(x, mask, np.array([0, 0, 8]), noise)
    assert torch.equal(a[:2], x[:2])
    torch.testing.assert_close(a[2], x[2] + 0.001 * noise[0, 2])


def test_scheduler_selections_equal_jax():
    grid = load_effects_config("conf/effects_config.yml").effect_param_grid
    ours = EffectScheduler(grid, rng=np.random.RandomState(3))
    ref = JScheduler(grid, rng=np.random.RandomState(3))
    specs = [tuple(s) for s in DEFAULT_TRAIN_EFFECTS]
    for step in range(5):
        i1, s1 = ours.select_bank_indices(32, specs)
        i2, s2 = ref.select_bank_indices(32, specs)
        np.testing.assert_array_equal(i1, i2)
        assert s1 == s2
        rng = np.random.RandomState(step)
        for (name, params), ber, miou in zip(s1, rng.rand(32) * 0.01,
                                             rng.rand(32)):
            ours.update_effect_metrics(name, params, float(ber), float(miou))
            ref.update_effect_metrics(name, params, float(ber), float(miou))
    assert ours.state_dict() == ref.state_dict()


def test_effects_config_equals_jax():
    ours, ref = load_effects_config(), jload()
    assert ours.train_effects == ref.train_effects
    assert ours.eval_effects == ref.eval_effects
    assert ours.effect_param_grid == ref.effect_param_grid
    assert ours.scheduler == ref.scheduler


@pytest.fixture(scope="module")
def branch_setup():
    jcfg, tcfg = tiny_configs(4, remat=False)
    state = create_train_state(tcfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    wm, _ = jax_params(state.models)
    return JModels.from_config(jcfg), wm, state.models


@pytest.mark.parametrize("clean,lowband,jitter", [(True, False, 0),
                                                  (False, True, 320),
                                                  (True, True, 320)])
def test_forward_train_extra_paths_match_jax(branch_setup, clean, lowband, jitter):
    """The clean and low-band read paths and the sub-hop jitter: rolls and
    masks exact, the generator's outputs within 1e-5, each detector on the
    port's input against JAX's detector on the same input within 1e-5."""
    jmodels, wm, models = branch_setup
    b, t = 4, 3200
    orig, _ = _clips(b, t, 9)
    msg = np.random.RandomState(10).randint(0, 2, (b, 16)).astype(np.float32)
    idx = np.array([0, 1, 2, 3], np.int32)
    bank_specs = [("identity", {}), ("highpass_filter", {"cutoff_freq": 500}),
                  ("random_noise", {"noise_std": 0.001}), ("speed", {"speed": 0.8})]
    key = jax.random.PRNGKey(11)
    k_fwd, _ = jax.random.split(jax.random.fold_in(key, 0))
    cutoff = 2000.0 if lowband else 0.0
    ref = jax.jit(lambda p, a, m, i: jforward_train(
        jmodels, p, k_fwd, a, m, i, JBank(bank_specs), remat=False,
        clean_detector=clean, jitter_hop=jitter, lowband_cutoff=cutoff))(
            wm, orig, msg, idx)
    bank = EffectBank(bank_specs)
    d = jax_draws(key, 0, b, t, len(bank_specs), bank.noise_branches,
                  jitter_hop=jitter)
    with torch.no_grad():
        out = forward_train(models, torch.from_numpy(orig), torch.from_numpy(msg),
                            idx, bank, d, remat=False, clean_detector=clean,
                            jitter_hop=jitter, lowband_cutoff=cutoff)
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(ref["mask"]))
    np.testing.assert_allclose(out["watermarked"].numpy(),
                               np.asarray(ref["watermarked"]), atol=1e-5, rtol=1e-5)
    w = out["watermarked"]
    if jitter:
        w = torch.gather(w, 1, (torch.arange(t)[None] - d.jitter_clean[:, None]) % t)
    inputs = {"detector_logits_clean": w}
    if lowband:
        from waveverify_torch.effects.effects import AudioEffects

        inputs["detector_logits_lowband"] = AudioEffects.lowpass_filter(
            w, None, None, cutoff_freq=2000.0)[0]
    det = jax.jit(jmodels.apply_detector)
    for name, x in inputs.items():
        if name not in out:
            continue
        # a lowpassed input leaves bins near zero whose log-STFT features
        # turn rounding into logit changes: hold the comparison to three
        # times the port's own move under x * (1 +- 1e-7) where that is
        # above 1e-5
        with torch.no_grad():
            floor = max(float((models.apply_detector(x * (1 + e)) - out[name])
                              .abs().max()) for e in (1e-7, -1e-7))
        err = np.abs(out[name].numpy()
                     - np.asarray(det(wm["detector"], x.numpy()))).max()
        assert err <= max(1e-5, 3 * floor), (name, err, floor)


@pytest.mark.parametrize("shape", [(4000,), (2, 4000)])
def test_apply_effect_keeps_the_shape(shape):
    from waveverify_tpu.effects.effects import apply_effect as japply
    from waveverify_torch.effects.effects import apply_effect

    x = np.random.RandomState(12).randn(*shape).astype(np.float32)
    y, m = apply_effect(torch.from_numpy(x), "lowpass_filter", cutoff_freq=2000)
    ref, _ = japply(jnp.asarray(x), "lowpass_filter", cutoff_freq=2000)
    assert y.shape == x.shape and m is None
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError, match="unknown effect"):
        apply_effect(torch.from_numpy(x), "no_such_effect")
