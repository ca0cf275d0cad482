"""The conv options only non-shipped configs reach, against the JAX modules
at small widths: every pad mode (the reflect small-input case included),
every normalisation each conv kind takes (weight norm, weight
standardization with its eps, the functional spectral norm, layer norm and
one-group norm after the conv), the refusals JAX makes, NormConvTranspose2d
on the cases of ``tests/test_conv.py``, ConvLayerNorm, and the learnable
and padded STFT. Every leaf of the JAX init is moved off its initial value
(gains, norm scales and biases too) and carried across by path.

Tolerance: atol 2e-5, rtol 1e-4 (one conv in f32 on both sides; the
normalisations' reductions and the power iteration add their own summation
orders); padding is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu.modules import conv as jconv
from waveverify_torch.modules import conv as tconv
from waveverify_torch.weights import export_params, flatten, load_params

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def perturbed(params, seed):
    """Every leaf of a flax tree moved off its init: ``v`` kept, the STFT
    basis by 1e-2, gains and scales multiplied by 1 +- 0.1, the rest (biases,
    zero gates) moved by 0.1 (0.3 for Dense kernels)."""
    rng = np.random.RandomState(seed)
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        noise = rng.randn(*v.shape).astype(np.float32)
        if leaf == "v":
            continue
        if leaf == "weight":
            flat[k] = v + 0.01 * noise
        elif leaf in ("g", "scale") or (leaf == "skip_scale" and np.all(v == 1)):
            flat[k] = v * (1.0 + 0.1 * noise)
        else:
            flat[k] = v + (0.3 if leaf == "kernel" else 0.1) * noise
    return flat


def run_both(jmod, tmod, x_nwc, seed=0, to_torch=(0, 2, 1)):
    """(JAX output, port output in JAX's layout) on the same perturbed
    parameters; ``to_torch`` permutes the input into the port's layout."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed),
                                jnp.asarray(x_nwc)).get("params", {})
    flat = perturbed(params, seed + 1)
    y_j = np.asarray(jax.jit(jmod.apply)({"params": _unflatten(flat)},
                                         jnp.asarray(x_nwc)))
    load_params(tmod, {f"m/{k}": v for k, v in flat.items()}, "m")
    with torch.no_grad():
        y_t = tmod(torch.from_numpy(np.ascontiguousarray(x_nwc.transpose(to_torch))))
    back = np.argsort(to_torch)
    return y_j, y_t.numpy().transpose(back)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate", "circular"])
@pytest.mark.parametrize("t,pads", [(9, (3, 5)), (4, (6, 2)), (3, (3, 0)),
                                    (2, (7, 9))])
def test_pad1d_matches_jax(mode, t, pads):
    """Each mode at pads inside the length and past it (the reflect
    small-input fix, a circular wrap over more than one period)."""
    x = np.random.RandomState(t).randn(2, t, 3).astype(np.float32)
    ref = np.asarray(jconv.pad1d(jnp.asarray(x), pads, mode=mode))
    got = tconv.pad1d(torch.from_numpy(x.transpose(0, 2, 1).copy()), pads, mode)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 1), ref)


def test_pad1d_refuses_unknown_mode():
    with pytest.raises(ValueError, match="unknown pad mode"):
        tconv.pad1d(torch.zeros(1, 1, 4), (1, 1), "mirror")


@pytest.mark.parametrize("mode", ["reflect", "replicate", "circular"])
@pytest.mark.parametrize("causal,stride", [(True, 1), (False, 1), (False, 3)])
def test_sconv1d_pad_modes_match_jax(mode, causal, stride):
    x = np.random.RandomState(1).randn(2, 23, 4).astype(np.float32)
    jm = jconv.SConv1d(features=6, kernel_size=5, stride=stride, causal=causal,
                       pad_mode=mode, norm="weight_norm")
    tm = tconv.SConv1d(4, 6, 5, stride=stride, causal=causal, pad_mode=mode,
                       norm="weight_norm")
    y_j, y_t = run_both(jm, tm, x)
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, **TOL)


CONV1D_NORMS = ["none", "weight_norm", "weight_standardization",
                "spectral_norm", "layer_norm", "time_group_norm"]


@pytest.mark.parametrize("norm", CONV1D_NORMS)
@pytest.mark.parametrize("cin,cout,k,groups,dilation", [(6, 10, 5, 1, 1),
                                                        (8, 8, 3, 8, 2),
                                                        (8, 12, 1, 4, 1)])
def test_norm_conv1d_matches_jax(norm, cin, cout, k, groups, dilation):
    x = np.random.RandomState(2).randn(3, 31, cin).astype(np.float32)
    jm = jconv.NormConv1d(features=cout, kernel_size=k, groups=groups,
                          dilation=dilation, norm=norm)
    tm = tconv.NormConv1d(cin, cout, k, groups=groups, dilation=dilation,
                          norm=norm)
    y_j, y_t = run_both(jm, tm, x)
    np.testing.assert_allclose(y_t, y_j, **TOL)


@pytest.mark.parametrize("eps", [1e-7, 10.0])
def test_weight_standardization_eps_from_norm_kwargs(eps):
    """eps sits under the rsqrt as a floor of var * fan_in: 10 clamps every
    output channel of these small kernels, 1e-7 none."""
    x = np.random.RandomState(3).randn(2, 17, 4).astype(np.float32)
    jm = jconv.NormConv1d(features=5, kernel_size=3, norm="weight_standardization",
                          norm_kwargs={"eps": eps})
    tm = tconv.NormConv1d(4, 5, 3, norm="weight_standardization",
                          norm_kwargs={"eps": eps})
    y_j, y_t = run_both(jm, tm, x)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    assert tuple(tm.g.shape) == (1, 1, 5)


@pytest.mark.parametrize("norm", ["none", "weight_norm", "weight_standardization",
                                  "layer_norm", "time_group_norm"])
@pytest.mark.parametrize("cin,cout,k,stride,groups", [(6, 4, 4, 2, 1),
                                                      (8, 8, 6, 3, 8)])
def test_norm_conv_transpose1d_matches_jax(norm, cin, cout, k, stride, groups):
    x = np.random.RandomState(4).randn(2, 13, cin).astype(np.float32)
    jm = jconv.NormConvTranspose1d(features=cout, kernel_size=k, stride=stride,
                                   groups=groups, norm=norm)
    tm = tconv.NormConvTranspose1d(cin, cout, k, stride=stride, groups=groups,
                                   norm=norm)
    y_j, y_t = run_both(jm, tm, x)
    np.testing.assert_allclose(y_t, y_j, **TOL)


@pytest.mark.parametrize("norm", ["none", "weight_norm", "weight_standardization"])
def test_norm_conv2d_matches_jax(norm):
    x = np.random.RandomState(5).randn(2, 9, 7, 4).astype(np.float32)
    jm = jconv.NormConv2d(features=6, kernel_size=(3, 2), stride=(2, 1),
                          padding=(1, 0), norm=norm)
    tm = tconv.NormConv2d(4, 6, (3, 2), stride=(2, 1), padding=(1, 0), norm=norm)
    y_j, y_t = run_both(jm, tm, x, to_torch=(0, 3, 1, 2))
    np.testing.assert_allclose(y_t, y_j, **TOL)


@pytest.mark.parametrize("norm", ["none", "weight_norm", "weight_standardization"])
@pytest.mark.parametrize("k,s,p,op,groups", [
    ((4, 4), (2, 2), (1, 1), (0, 0), 1),
    ((3, 5), (1, 2), (0, 1), (0, 1), 1),
    ((4, 4), (2, 2), (0, 0), (0, 0), 4),
])
def test_norm_conv_transpose2d_matches_jax(norm, k, s, p, op, groups):
    """The cases of tests/test_conv.py's NormConvTranspose2d test."""
    x = np.random.RandomState(6).randn(2, 9, 11, 8).astype(np.float32)
    jm = jconv.NormConvTranspose2d(features=8, kernel_size=k, stride=s, padding=p,
                                   output_padding=op, groups=groups, norm=norm)
    tm = tconv.NormConvTranspose2d(8, 8, k, stride=s, padding=p,
                                   output_padding=op, groups=groups, norm=norm)
    y_j, y_t = run_both(jm, tm, x, to_torch=(0, 3, 1, 2))
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, **TOL)


def test_conv_transpose2d_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    w = rng.randn(4, 3, 3, 2).astype(np.float32)  # (Cin, Cout / g, Kh, Kw)
    ref = np.asarray(jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                                            (2, 3), groups=2, dilation=(1, 2)))
    got = tconv.conv_transpose2d(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                 torch.from_numpy(w), (2, 3), groups=2,
                                 dilation=(1, 2))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), ref, **TOL)


REFUSED = [
    ("NormConv1d", "time_layer_norm", NotImplementedError),
    ("NormConvTranspose1d", "spectral_norm", NotImplementedError),
    ("NormConvTranspose1d", "time_layer_norm", NotImplementedError),
    ("NormConv2d", "spectral_norm", NotImplementedError),
    ("NormConv2d", "layer_norm", NotImplementedError),
    ("NormConv2d", "time_group_norm", NotImplementedError),
    ("NormConvTranspose2d", "spectral_norm", NotImplementedError),
    ("NormConvTranspose2d", "layer_norm", NotImplementedError),
    ("NormConv1d", "batch_norm", ValueError),
    ("NormConv2d", "batch_norm", ValueError),
]


@pytest.mark.parametrize("cls,norm,exc", REFUSED)
def test_refuses_what_jax_refuses(cls, norm, exc):
    """Where JAX refuses a norm, the port refuses it with the same error
    type and message (JAX at apply time, the port at construction)."""
    two_d = cls.endswith("2d")
    x = jnp.zeros((1, 6, 6, 4) if two_d else (1, 6, 4))
    kernel = (3, 3) if two_d else 3
    with pytest.raises(exc) as j_err:
        getattr(jconv, cls)(features=4, kernel_size=kernel, norm=norm).init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(exc) as t_err:
        getattr(tconv, cls)(4, 4, kernel, norm=norm)
    assert str(t_err.value) == str(j_err.value)


def test_norm_leaves_are_the_flax_tree():
    """The norm modules' parameters sit where flax puts them."""
    for norm, leaves in [("layer_norm", {"v", "b", "norm/LayerNorm_0/scale",
                                         "norm/LayerNorm_0/bias"}),
                         ("time_group_norm", {"v", "b", "norm/scale", "norm/bias"}),
                         ("weight_standardization", {"v", "g", "b"}),
                         ("spectral_norm", {"v", "b"})]:
        params = jconv.NormConv1d(features=4, kernel_size=3, norm=norm).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 5, 2)))["params"]
        flat = flatten(jax.tree_util.tree_map(np.asarray, params))
        assert set(flat) == leaves
        got = export_params(tconv.NormConv1d(2, 4, 3, norm=norm), "m")
        assert {k[2:]: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in flat.items()}


def test_init_values_match_jax():
    """Gains, norm scales and biases start where JAX's initialisers put
    them; weight norm's g is ||v||."""
    for norm in ("weight_norm", "weight_standardization", "layer_norm",
                 "time_group_norm"):
        params = jconv.NormConv1d(features=4, kernel_size=3, norm=norm).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 5, 2)))["params"]
        flat = flatten(jax.tree_util.tree_map(np.asarray, params))
        tm = tconv.NormConv1d(2, 4, 3, norm=norm)
        tconv.init_params(tm, torch.Generator().manual_seed(0))
        for k, p in tm.named_parameters():
            if k == "v":
                continue
            want = flat[k.replace(".", "/")]
            if k == "g" and norm == "weight_norm":
                want = torch.linalg.vector_norm(tm.v, dim=(1, 2)).detach().numpy()
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                       err_msg=f"{norm} {k}")


def test_conv_layer_norm_matches_jax():
    x = (np.random.RandomState(8).randn(2, 11, 6) * 3 + 1).astype(np.float32)
    y_j, y_t = run_both(jconv.ConvLayerNorm(), tconv.ConvLayerNorm(6), x)
    np.testing.assert_allclose(y_t, y_j, **TOL)


@pytest.mark.parametrize("learnable", [False, True])
@pytest.mark.parametrize("pad_mode", ["constant", "reflect", "replicate"])
def test_causal_stft_options_match_jax(learnable, pad_mode):
    """The learnable basis (perturbed off the DFT) and the padded modes;
    reflect at n_fft - 1 = 63 > T exercises the small-input fix."""
    x = (np.random.RandomState(9).randn(2, 50, 1) * 0.1).astype(np.float32)
    jm = jconv.CausalSTFT(n_fft=64, hop_size=4, pad_mode=pad_mode,
                          learnable=learnable)
    tm = tconv.CausalSTFT(64, 4, pad_mode=pad_mode, learnable=learnable)
    y_j, y_t = run_both(jm, tm, x)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-4)
    if learnable:
        tconv.init_params(tm, torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(
            tm.weight.detach().numpy(),
            np.transpose(jconv.dft_basis(64), (2, 1, 0)))
