"""The effect bank's "scan" dispatch against the JAX package's
(``EffectBank._apply_scan``), f32 on the CPU: the 20-branch catalog bank,
each sample on its own branch and fed the draws JAX's per-sample keys give
(``torch_jax_bridge.jax_scan_draws``), within 2e-6 with masks equal, and
its gradient against ``jax.grad`` within 1e-5; "scan" equal to "stack" on
the branches without randomness; the per-sample draws' shapes; a bad
dispatch mode refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.catalog import CATALOG20
from tests.torch_jax_bridge import jax_scan_draws
from waveverify_tpu.effects import effects as jeffects
from waveverify_torch.effects import effects
from waveverify_torch.train.watermarking import draw

torch.set_num_threads(2)

ATOL = 2e-6
GRAD_ATOL = 1e-5
# long enough for the echo's longest delay (0.5 s) to land inside the clip
B, T = 20, 12000
KEY = jax.random.PRNGKey(11)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    audio = (rng.randn(B, T) * 0.1).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    for i, s in enumerate(rng.randint(0, T - T // 5, B)):
        mask[i, s:s + T // 5] = 0.0
    return audio, mask


# each sample on its own branch, in two orders; every sample on the echo
# (a per-call draw in "stack", per sample in "scan"); the noises and the
# suppression, whose per-row draws are joined into one call
IDX = {
    "reversed": np.arange(B, dtype=np.int32)[::-1].copy(),
    "rolled": np.roll(np.arange(B, dtype=np.int32), 7),
    "all_echo": np.full(B, [n for n, _ in CATALOG20].index("echo"), np.int32),
    "noises": np.array([8, 11, 12, 15] * 5, np.int32),
}


@pytest.fixture(scope="module")
def jax_scan():
    bank = jeffects.EffectBank(CATALOG20, dispatch="scan")
    return jax.jit(bank.apply)


@pytest.mark.parametrize("order", sorted(IDX))
def test_scan_bank_matches_jax(jax_scan, order):
    audio, mask = _inputs()
    idx = IDX[order]
    ref_a, ref_m = jax_scan(jnp.asarray(audio), jnp.asarray(mask),
                            jnp.asarray(idx), KEY)
    bank = effects.EffectBank(CATALOG20, dispatch="scan")
    fx = jax_scan_draws(KEY, CATALOG20, idx, T)
    a, m = bank.apply(torch.from_numpy(audio), torch.from_numpy(mask), idx, fx)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))


def test_scan_draws_differ_per_sample(jax_scan):
    """Under "scan" every sample of the echo branch takes its own delay and
    volume, so two samples of the same clip come out apart; under "stack"
    they share one draw and come out equal."""
    audio, mask = _inputs()
    audio[1] = audio[0]
    idx = IDX["all_echo"]
    ref_a, _ = jax_scan(jnp.asarray(audio), jnp.asarray(mask), jnp.asarray(idx),
                        KEY)
    assert np.abs(np.asarray(ref_a)[0] - np.asarray(ref_a)[1]).max() > 1e-3
    stack = effects.EffectBank(CATALOG20)
    gen = torch.Generator().manual_seed(0)
    fx = [effects.draw_effect(n, p, gen, B, T) for n, p in stack.random_specs]
    a, _ = stack.apply(torch.from_numpy(audio), torch.from_numpy(mask), idx, fx)
    torch.testing.assert_close(a[0], a[1], rtol=0, atol=0)


def test_scan_bank_gradient_matches_jax(jax_scan):
    """The gradient of ``sum(out * w)`` through every branch, against
    ``jax.grad`` of the JAX "scan" bank."""
    audio, mask = _inputs(1)
    idx = IDX["reversed"]
    w = np.random.RandomState(2).randn(B, T).astype(np.float32)
    jbank = jeffects.EffectBank(CATALOG20, dispatch="scan")
    g_j = jax.jit(jax.grad(lambda a: jnp.sum(
        jbank.apply(a, jnp.asarray(mask), jnp.asarray(idx), KEY)[0] * w)))(
            jnp.asarray(audio))
    bank = effects.EffectBank(CATALOG20, dispatch="scan")
    a = torch.from_numpy(audio).requires_grad_(True)
    out, _ = bank.apply(a, torch.from_numpy(mask), idx,
                        jax_scan_draws(KEY, CATALOG20, idx, T))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=GRAD_ATOL)


def test_scan_equals_stack_without_randomness():
    """On the branches that draw nothing the two dispatch modes run the
    same code on the same rows: equal bit for bit."""
    audio, mask = _inputs(3)
    plain = [i for i, (n, _) in enumerate(CATALOG20) if n not in effects.RANDOM_EFFECTS]
    idx = np.array([plain[i % len(plain)] for i in range(B)], np.int32)
    stack = effects.EffectBank(CATALOG20)
    scan = effects.EffectBank(CATALOG20, dispatch="scan")
    a_s, m_s = stack.apply(torch.from_numpy(audio), torch.from_numpy(mask), idx,
                           [{} for _ in stack.random_branches])
    a_c, m_c = scan.apply(torch.from_numpy(audio), torch.from_numpy(mask), idx,
                          [{} for _ in range(B)])
    torch.testing.assert_close(a_c, a_s, rtol=0, atol=0)
    torch.testing.assert_close(m_c, m_s, rtol=0, atol=0)


def test_per_sample_draws_follow_the_branches():
    """``draw_specs`` lists each sample's branch under "scan" and the random
    branches under "stack"; ``draw(per_sample=True)`` draws each random
    sample at batch 1 and nothing for the others."""
    idx = IDX["noises"].copy()
    idx[0] = 0  # identity
    scan = effects.EffectBank(CATALOG20, dispatch="scan")
    stack = effects.EffectBank(CATALOG20)
    assert stack.draw_specs(idx) == stack.random_specs
    specs = scan.draw_specs(idx)
    assert specs == [CATALOG20[e] for e in idx]
    d = draw(torch.Generator().manual_seed(0), B, T, specs, per_sample=True)
    assert d.fx[0] == {}
    assert d.fx[1]["noise"].shape == (1, T)           # white_noise
    assert d.fx[2]["rows"][0].shape == (1, T)         # pink_noise
    assert d.fx[3]["u"].shape == (1, T)               # sample_suppression
    assert d.fx[4]["noise"].shape == (1, T)           # random_noise
    d = draw(torch.Generator().manual_seed(0), B, T, stack.random_specs)
    assert len(d.fx) == len(stack.random_branches)
    assert d.fx[0]["noise"].shape == (B, T)


def test_bad_dispatch_mode_raises():
    with pytest.raises(ValueError, match="invalid dispatch mode 'switch'"):
        effects.EffectBank(CATALOG20, dispatch="switch")
    with pytest.raises(ValueError, match="invalid dispatch mode"):
        jeffects.EffectBank(CATALOG20, dispatch="switch")
