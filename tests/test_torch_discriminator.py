"""The port's discriminator ensemble (MPD, MSD, MRD) against the JAX
package's with the same parameters: feature maps, the discriminator loss
with its gradient penalty at the same alpha, and that loss's parameter
gradients (f32 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu.config import DiscriminatorConfig as JDiscConfig
from waveverify_tpu.losses import discriminator_loss as jdisc_loss
from waveverify_tpu.losses import generator_loss as jgen_loss
from waveverify_tpu.models.discriminator import Discriminator as JDisc
from waveverify_torch.config import DiscriminatorConfig
from waveverify_torch.losses import discriminator_loss, generator_loss
from waveverify_torch.models.discriminator import Discriminator
from waveverify_torch.modules.conv import init_params
from waveverify_torch.weights import export_params, flatten, load_params

torch.set_num_threads(2)

B, T = 2, 3000
CFG = dict(periods=(2, 3), rates=(2,), fft_sizes=(512, 256))


@pytest.fixture(scope="module")
def discs():
    """The JAX ensemble with its own init, and the port's loaded from it."""
    jd = JDisc(config=JDiscConfig(**CFG))
    params = jax.jit(jd.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, T, 1)))["params"]
    flat = flatten(jax.tree_util.tree_map(np.asarray, params), "d")
    td = Discriminator(DiscriminatorConfig(**CFG))
    load_params(td, flat, "d")
    return jd, params, td


def _audio(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T) * 0.2).astype(np.float32)


def test_carried_parameters_round_trip(discs):
    _, params, td = discs
    flat = flatten(jax.tree_util.tree_map(np.asarray, params), "d")
    out = export_params(td, "d")
    assert set(out) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k])


def test_feature_maps_match_jax(discs):
    jd, params, td = discs
    x = _audio(1)
    ref = jax.jit(lambda p, a: jd.apply({"params": p}, a[..., None]))(params, x)
    with torch.no_grad():
        out = td(torch.from_numpy(x))
    assert len(out) == len(ref) == 5
    for sub, (maps, jmaps) in enumerate(zip(out, ref)):
        assert len(maps) == len(jmaps)
        for i, (m, jm) in enumerate(zip(maps, jmaps)):
            jm = np.asarray(jm)
            # NHWC / NWC -> the port's NCHW / NCW
            jm = np.moveaxis(jm, -1, 1)
            assert m.shape == jm.shape, (sub, i)
            scale = max(np.abs(jm).max(), 1e-3)
            np.testing.assert_allclose(m.numpy(), jm, rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=f"{sub}/{i}")


@pytest.fixture(scope="module")
def disc_loss_and_grads(discs):
    jd, params, td = discs
    fake, real = _audio(2) * 0.5, _audio(3)
    key = jax.random.PRNGKey(4)
    alpha = np.array(jax.random.uniform(key, (B, 1)))[:, 0].copy()

    def loss(p):
        return jdisc_loss(lambda x: jd.apply({"params": p}, x[..., None]),
                          fake, real, key=key)

    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    td.zero_grad()
    tl = discriminator_loss(td, torch.from_numpy(fake), torch.from_numpy(real),
                            alpha=torch.from_numpy(alpha))
    tl.backward()
    grads = {}
    saved = {n: p.detach().clone() for n, p in td.named_parameters()}
    with torch.no_grad():
        for p in td.parameters():
            p.copy_(p.grad)
        grads = export_params(td, "d")
        for n, p in td.named_parameters():
            p.copy_(saved[n])
    jflat = flatten(jax.tree_util.tree_map(np.asarray, jg), "d")
    return float(jl), float(tl.detach()), jflat, grads


def test_discriminator_loss_with_gp_matches_jax(disc_loss_and_grads):
    jl, tl, _, _ = disc_loss_and_grads
    assert abs(tl - jl) <= 1e-4 * abs(jl), (tl, jl)


@pytest.mark.parametrize("sub", ["mpd_0", "mpd_1", "msd_0", "mrd_0", "mrd_1"])
def test_discriminator_gradients_match_jax(disc_loss_and_grads, sub):
    """Each sub-discriminator's parameter gradients, rel 1e-4 of the
    largest gradient of that parameter."""
    _, _, jflat, grads = disc_loss_and_grads
    keys = [k for k in jflat if k.startswith(f"d/{sub}/")]
    assert keys
    for k in keys:
        scale = max(np.abs(jflat[k]).max(), 1e-12)
        err = np.abs(grads[k] - jflat[k]).max() / scale
        assert err <= 1e-4, (k, err)


def test_generator_loss_matches_jax(discs):
    jd, params, td = discs
    fake, real = _audio(5) * 0.5, _audio(6)
    app = jax.jit(lambda p, a: jd.apply({"params": p}, a[..., None]))
    jg, jf = jgen_loss(lambda x: app(params, x), jnp.asarray(fake), jnp.asarray(real))
    with torch.no_grad():
        g, f = generator_loss(td, torch.from_numpy(fake), torch.from_numpy(real))
    assert abs(float(g) - float(jg)) <= 1e-5 * abs(float(jg))
    assert abs(float(f) - float(jf)) <= 1e-5 * abs(float(jf))


def test_port_init_is_finite_and_the_gp_is_second_order():
    """From the port's own init, the penalty's gradient reaches every
    parameter and is finite."""
    td = Discriminator(DiscriminatorConfig(periods=(2,), fft_sizes=(256,)))
    init_params(td, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_audio(7))
    loss = discriminator_loss(td, x * 0.5, x, alpha=torch.full((B,), 0.3),
                              gp_weight=10.0)
    loss.backward()
    for n, p in td.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
