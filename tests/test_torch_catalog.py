"""The rest of the effect catalog against the JAX package's, f32 on the
CPU, each random effect fed the JAX package's own draws
(``torch_jax_bridge.jax_effect_draws``): outputs within 2e-6 absolute (as
``test_torch_effects.py``), masks equal; the straight-through and masked
gradients against ``jax.grad`` of ``sum(out * w)`` within 1e-6;
``apply_effect`` on ``[B, T, 1]``; the encodec fallback; and the JAX
"stack" bank of all 20 on-device branches, each sample on its own branch.

JAX's own ``encodec`` is never called here: it would try to fetch weights.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_bridge import jax_bank_draws, jax_effect_draws
from waveverify_tpu.effects import effects as jeffects
from waveverify_torch.effects import effects

torch.set_num_threads(2)

ATOL = 2e-6
GRAD_ATOL = 1e-6
SR = 16000
KEY = jax.random.PRNGKey(3)


def _audio(b=3, t=4000, seed=0):
    return (np.random.RandomState(seed).randn(b, t) * 0.1).astype(np.float32)


def _mask(b=3, t=4000, seed=1):
    rng = np.random.RandomState(seed)
    m = np.ones((b, t), np.float32)
    for i, s in enumerate(rng.randint(0, t - t // 5, b)):
        m[i, s:s + t // 5] = 0.0
    return m


# (name, params, T): every new on-device effect; the median at odd and even
# windows; pink noise at T that is no multiple of 2^15 and past it
CASES = [
    ("random_equalization", {}, 4000),
    ("random_equalization", {"gain_range": (3.0, 6.0), "q": 2.0,
                             "freq_range": (500.0, 1000.0)}, 4000),
    ("echo", {}, 12000),
    ("echo", {"duration_range": (0.01, 0.05), "volume_range": (0.3, 0.6)}, 4000),
    ("white_noise", {}, 4000),
    ("white_noise", {"noise_std": 0.05}, 4000),
    ("pink_noise", {}, 4000),
    ("pink_noise", {"noise_std": 0.02}, 40000),
    ("pink_noise", {"depth": 5}, 4001),
    ("amplitude_scaling", {"scale": 0.5}, 4000),
    ("quantization", {}, 4000),
    ("quantization", {"bit_depth": 4}, 4000),
    ("sample_suppression", {}, 4000),
    ("sample_suppression", {"suppression_percentage": 0.4}, 4000),
    ("shush", {}, 4000),
    ("shush", {"fraction": 0.05}, 4000),
    ("median_filter", {"kernel_size": 3}, 4000),
    ("median_filter", {"kernel_size": 4}, 4000),
    ("median_filter", {"kernel_size": 5}, 4000),
    ("smooth", {}, 4000),
    ("smooth", {"window_size": 4}, 4000),
    ("codec_proxy", {}, 4000),
    ("codec_proxy", {"bit_depth": 6, "cutoff_freq": 3000.0}, 4000),
]


def _port(name, params, audio, mask, key=KEY):
    """The port's effect on the inputs, fed JAX's draws under ``key``."""
    kw = dict(params)
    if name in effects.RANDOM_EFFECTS:
        kw.update(jax_effect_draws(name, params, key, *audio.shape))
    return getattr(effects.AudioEffects, name)(audio, mask, None,
                                              sample_rate=SR, **kw)


def _jax(name, params, audio, mask, key=KEY):
    return getattr(jeffects.AudioEffects, name)(
        jnp.asarray(audio), None if mask is None else jnp.asarray(mask), key,
        sample_rate=SR, **params)


@pytest.mark.parametrize("name,params,t", CASES,
                         ids=[f"{n}{tuple(p.values())}-{t}" for n, p, t in CASES])
def test_effect_matches_jax(name, params, t):
    audio, mask = _audio(t=t), _mask(t=t)
    y_j, m_j = _jax(name, params, audio, mask)
    y_t, m_t = _port(name, params, torch.from_numpy(audio),
                     torch.from_numpy(mask))
    assert y_t.shape == audio.shape and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_shush_with_ties_matches_jax():
    """Magnitudes on a coarse grid, so the k-th smallest is shared by many
    samples: every tie at the threshold is zeroed, on both sides."""
    audio = np.round(_audio(3, 4000, seed=4) * 16) / 16
    params = {"fraction": 0.3}
    y_j, _ = _jax("shush", params, audio, None)
    y_t, _ = _port("shush", params, torch.from_numpy(audio), None)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    zeroed = (y_t == 0).float().mean().item()
    assert zeroed > 0.3  # the ties at the threshold went too


def test_random_effects_draw_their_own_randomness():
    """Without draws, a random effect draws from the generator: a seed
    gives the same output, another seed another one (1 s, longer than
    the echo's longest delay)."""
    audio = torch.from_numpy(_audio(2, 16000))
    for name in effects.RANDOM_EFFECTS:
        fn = getattr(effects.AudioEffects, name)
        run = [fn(audio, None, torch.Generator().manual_seed(s))[0]
               for s in (1, 1, 2)]
        torch.testing.assert_close(run[0], run[1], atol=0, rtol=0)
        assert not torch.equal(run[0], run[2]), name


GRAD_CASES = [
    ("quantization", {}),
    ("median_filter", {"kernel_size": 3}),
    ("median_filter", {"kernel_size": 4}),
    ("codec_proxy", {}),
    ("shush", {"fraction": 0.05}),
    ("sample_suppression", {"suppression_percentage": 0.3}),
]


@pytest.mark.parametrize("name,params", GRAD_CASES,
                         ids=[f"{n}{tuple(p.values())}" for n, p in GRAD_CASES])
def test_effect_gradient_matches_jax(name, params):
    """The straight-through (quantization, median, codec proxy) and masked
    (shush, sample suppression) gradients of ``sum(out * w)``."""
    audio = _audio(2, 3000, seed=5)
    w = np.random.RandomState(6).randn(*audio.shape).astype(np.float32)
    g_j = jax.grad(lambda a: jnp.sum(_jax(name, params, a, None)[0] * w))(
        jnp.asarray(audio))
    a = torch.from_numpy(audio).requires_grad_(True)
    (_port(name, params, a, None)[0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_j), atol=GRAD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name,params", [("sample_suppression", {}),
                                         ("smooth", {"window_size": 5}),
                                         ("quantization", {})])
def test_apply_effect_on_btc_input_matches_jax(name, params):
    """``[B, T, 1]`` audio and mask keep their shape, as in JAX; ``[T]``
    audio too."""
    audio, mask = _audio()[..., None], _mask()[..., None]
    kw = dict(params)
    if name in effects.RANDOM_EFFECTS:
        kw.update(jax_effect_draws(name, params, KEY, 3, 4000))
    y_t, m_t = effects.apply_effect(torch.from_numpy(audio), name,
                                    torch.from_numpy(mask), **kw)
    y_j, m_j = jeffects.apply_effect(jnp.asarray(audio), name,
                                     jnp.asarray(mask), KEY, **params)
    assert y_t.shape == audio.shape and m_t.shape == mask.shape
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    one = audio[0, :, 0]
    y1, _ = effects.apply_effect(torch.from_numpy(one), "quantization")
    assert y1.shape == one.shape
    with pytest.raises(ValueError, match=r"\[B, T, 1\]"):
        effects.apply_effect(torch.zeros(2, 100, 2), "identity")


def test_encodec_falls_back_to_the_proxy(caplog):
    audio, mask = torch.from_numpy(_audio()), torch.from_numpy(_mask())
    effects.AudioEffects.encodec_last_was_proxy = False
    with caplog.at_level(logging.WARNING):
        y, m = effects.AudioEffects.encodec(audio, mask, None)
    assert effects.AudioEffects.encodec_last_was_proxy is True
    assert any("codec_proxy" in r.getMessage() for r in caplog.records)
    ref, _ = effects.AudioEffects.codec_proxy(audio, mask, None)
    torch.testing.assert_close(y, ref, atol=0, rtol=0)
    assert m is mask
    y_j, _ = jeffects.AudioEffects.codec_proxy(jnp.asarray(audio.numpy()), None)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL, rtol=0)
    assert effects.codec_available("encodec") is False


# the shipped 9 branches and every new on-device effect (all but encodec)
NEW_BRANCHES = [
    ("random_equalization", {}),
    ("echo", {"duration_range": (0.01, 0.1)}),
    ("white_noise", {"noise_std": 0.01}),
    ("pink_noise", {"noise_std": 0.01}),
    ("amplitude_scaling", {"scale": 0.7}),
    ("quantization", {"bit_depth": 8}),
    ("sample_suppression", {"suppression_percentage": 0.1}),
    ("shush", {"fraction": 0.001}),
    ("median_filter", {"kernel_size": 4}),
    ("smooth", {"window_size": 5}),
    ("codec_proxy", {}),
]
BANK20 = list(effects.DEFAULT_TRAIN_EFFECTS) + NEW_BRANCHES


def test_twenty_branch_bank_matches_jax():
    """Every branch on its own sample, against the JAX bank's ``stack``
    dispatch under one key; the bank's draws from the JAX key chain."""
    assert len(BANK20) == 20
    b, t = 20, 4000
    audio = _audio(b, t, seed=7)
    mask = _mask(b, t, seed=8)
    idx = np.arange(b, dtype=np.int32)[::-1].copy()
    key = jax.random.PRNGKey(9)
    jbank, bank = jeffects.EffectBank(BANK20), effects.EffectBank(BANK20)
    assert bank.random_branches == [8, 9, 10, 11, 12, 15]
    ref_a, ref_m = jax.jit(jbank.apply)(jnp.asarray(audio), jnp.asarray(mask),
                                        jnp.asarray(idx), key)
    fx = jax_bank_draws(key, bank.specs, b, t)
    a, m = bank.apply(torch.from_numpy(audio), torch.from_numpy(mask), idx, fx)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))


def test_bank_rejects_unknown_effects():
    with pytest.raises(ValueError, match="unknown effect"):
        effects.EffectBank([("no_such_effect", {})])
    with pytest.raises(ValueError, match="unknown effect"):
        effects.EffectBank([("encodec_last_was_proxy", {})])


def test_echo_taps_ahead_as_jax():
    """The echo's direction (``ROADMAP.md`` §3): as the JAX package's
    cross-correlation, ``y[t] = x[t] + volume * x[t + delay]`` (rescaled to
    the input's peak), not the reference's causal ``x[t - delay]``. On 1 s
    of N(0, 0.1) noise at delay 0.3 s and volume 0.3 the two directions
    differ by up to 0.146, median 0.022."""
    x = _audio(1, 16000, seed=0)
    dur, vol, d = 0.3, 0.3, 4800
    y, _ = effects.AudioEffects.echo(torch.from_numpy(x), None, None,
                                     duration=torch.tensor(dur),
                                     volume=torch.tensor(vol))
    y = y.numpy()[0]

    def rescaled(z):
        return z / (np.abs(z).max() + 1e-9) * np.abs(x[0]).max()

    ahead, causal = x[0].copy(), x[0].copy()
    ahead[:-d] += vol * x[0][d:]
    causal[d:] += vol * x[0][:-d]
    np.testing.assert_allclose(y, rescaled(ahead), atol=ATOL, rtol=0)
    dev = np.abs(y - rescaled(causal))
    assert abs(dev.max() - 0.146) < 1e-3 and abs(np.median(dev) - 0.022) < 1e-3
