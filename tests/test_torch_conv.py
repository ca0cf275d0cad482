"""Port conv primitives against the JAX modules at small widths, with the
same randomly initialised params carried across. Tolerance for f32 convs:
atol 1e-5, rtol 1e-5 (both sides compute in f32; only the summation order
differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from waveverify_tpu.modules import conv as jconv
from waveverify_torch.modules import conv as tconv
from waveverify_torch.weights import flatten, load_params

torch.set_num_threads(2)


def _params(module, x, seed=0, bias_scale=0.2):
    """Init a flax module; give its zero-init biases random values."""
    params = module.init(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.RandomState(seed + 1)
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    for k, v in flat.items():
        if k.split("/")[-1] == "b":
            flat[k] = (rng.randn(*v.shape) * bias_scale).astype(np.float32)
    return flat


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _run_both(jmod, tmod, x_btc, seed=0):
    flat = _params(jmod, jnp.asarray(x_btc), seed)
    y_j = np.asarray(jmod.apply({"params": _unflatten(flat)}, jnp.asarray(x_btc)))
    load_params(tmod, {f"m/{k}": v for k, v in flat.items()}, "m")
    with torch.no_grad():
        y_t = tmod(torch.from_numpy(np.ascontiguousarray(x_btc.transpose(0, 2, 1))))
    return y_j, y_t.numpy().transpose(0, 2, 1)


@pytest.mark.parametrize(
    "cin,cout,k,stride,groups,causal,t",
    [(4, 6, 5, 1, 1, True, 37),      # causal
     (6, 6, 4, 2, 6, True, 51),      # strided depthwise, T not a stride multiple
     (8, 8, 10, 5, 8, True, 33),     # the encoder's ratio-5 downsample shape
     (4, 4, 5, 1, 1, False, 29),     # centred padding
     (3, 5, 7, 3, 1, False, 40)])    # strided dense, non-causal
def test_sconv1d_matches_jax(cin, cout, k, stride, groups, causal, t):
    rng = np.random.RandomState(3)
    x = rng.randn(2, t, cin).astype(np.float32)
    jmod = jconv.SConv1d(features=cout, kernel_size=k, stride=stride,
                         groups=groups, causal=causal, norm="weight_norm")
    tmod = tconv.SConv1d(cin, cout, k, stride=stride, groups=groups,
                         causal=causal, norm="weight_norm")
    y_j, y_t = _run_both(jmod, tmod, x)
    assert y_t.shape == y_j.shape == (2, -(-t // stride), cout)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "cin,cout,k,stride,groups,causal",
    [(6, 6, 16, 8, 6, True),   # the decoder's depthwise upsampler
     (8, 8, 4, 2, 8, True),
     (4, 6, 6, 3, 1, True),    # dense
     (4, 4, 6, 2, 1, False)])
def test_sconv_transpose1d_matches_jax(cin, cout, k, stride, groups, causal):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 13, cin).astype(np.float32)
    jmod = jconv.SConvTranspose1d(features=cout, kernel_size=k, stride=stride,
                                  groups=groups, causal=causal,
                                  norm="weight_norm")
    tmod = tconv.SConvTranspose1d(cin, cout, k, stride=stride, groups=groups,
                                  causal=causal, norm="weight_norm")
    y_j, y_t = _run_both(jmod, tmod, x)
    assert y_t.shape == y_j.shape == (2, 13 * stride, cout)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_fft", [64, 256, 1024])
def test_dft_basis_is_bit_identical(n_fft):
    np.testing.assert_array_equal(tconv.dft_basis(n_fft), jconv.dft_basis(n_fft))


@pytest.mark.parametrize("n_fft,hop", [(64, 1), (128, 8), (512, 40)])
def test_causal_stft_matches_jax(n_fft, hop):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 1003) * 0.1).astype(np.float32)
    y_j = np.asarray(jconv.CausalSTFT(n_fft=n_fft, hop_size=hop).apply(
        {}, jnp.asarray(x)))
    with torch.no_grad():
        y_t = tconv.CausalSTFT(n_fft, hop)(torch.from_numpy(x)[:, None, :])
    y_t = y_t.numpy().transpose(0, 2, 1)
    assert y_t.shape == y_j.shape
    # magnitudes up to ~n_fft * 0.1: 1e-5 relative to that scale
    np.testing.assert_allclose(y_t, y_j, atol=1e-5 * n_fft * 0.1, rtol=1e-5)


class _Head(nn.Module):
    length: int

    @nn.compact
    def __call__(self, z):
        rc = jconv.NormConvTranspose1d(features=6, kernel_size=8, stride=8,
                                       norm="none", use_bias=True, name="rc")
        ll = jconv.NormConv1d(features=4, kernel_size=1, norm="none",
                              use_bias=True, name="ll")
        return jconv.fused_upsample_head(rc, ll, z, self.length)


def test_fused_upsample_head_matches_jax():
    rng = np.random.RandomState(6)
    length = 8 * 5 - 3  # not a hop multiple
    z = rng.randn(2, 5, 10).astype(np.float32)
    jmod = _Head(length=length)
    flat = _params(jmod, jnp.asarray(z))
    y_j = np.asarray(jmod.apply({"params": _unflatten(flat)}, jnp.asarray(z)))
    rc = tconv.NormConvTranspose1d(10, 6, 8, stride=8, norm="none")
    ll = tconv.NormConv1d(6, 4, 1, norm="none")
    load_params(rc, flat, "rc")
    load_params(ll, flat, "ll")
    with torch.no_grad():
        y_t = tconv.fused_upsample_head(
            rc, ll, torch.from_numpy(np.ascontiguousarray(z.transpose(0, 2, 1))),
            length).numpy()
    assert y_t.shape == y_j.shape == (2, length, 4)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-5)


def test_padding_helpers():
    assert tconv.get_extra_padding_for_conv1d(51, 4, 2, 2) == \
        jconv.get_extra_padding_for_conv1d(51, 4, 2, 2)
    x = torch.arange(6, dtype=torch.float32)[None, None]
    np.testing.assert_array_equal(
        tconv.pad1d(x, (2, 3)).numpy()[0, 0],
        np.asarray(jconv.pad1d(jnp.arange(6.0)[None, :, None], (2, 3)))[0, :, 0])
    assert tconv.unpad1d(x, (1, 2)).shape[-1] == 3
    with pytest.raises(ValueError):
        tconv.pad1d(x, (-1, 0))

