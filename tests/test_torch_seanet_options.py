"""The SEANet options only non-shipped configs reach, against the JAX modules
at small widths (dimension 32, n_filters 8): every activation, Scale, every
skip type, act_all, expansion, groups, zero_init, the norms and pad modes
inside a residual block, the power spectrogram and the learnable STFT in
the encoder, and the decoder with the same options. Every leaf of the JAX
init is moved off its initial value (the zero-init gates too, which would
otherwise hide the residual branch) and carried across by path.

Tolerance: atol 1e-4, rtol 1e-4, as ``test_torch_seanet.py``'s encoder test
(a stack of ~20 convs in f32 with different summation orders); the
activations alone atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_conv_options import perturbed, run_both
from tests.test_torch_seanet import _unflatten
from waveverify_tpu.modules import seanet as jseanet
from waveverify_torch.modules import seanet as tseanet
from waveverify_torch.modules.conv import init_params
from waveverify_torch.weights import load_params

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)

ACTIVATIONS = [("ELU", {"alpha": 0.5}), ("ReLU", {}), ("LeakyReLU", {}),
               ("LeakyReLU", {"negative_slope": 0.2}), ("GELU", {}),
               ("Tanh", {}), ("Sigmoid", {})]


@pytest.mark.parametrize("name,params", ACTIVATIONS)
def test_activation_matches_jax(name, params):
    x = np.random.RandomState(0).randn(4, 50).astype(np.float32) * 3
    ref = np.asarray(jseanet.get_activation(name, params)(jnp.asarray(x)))
    got = tseanet.get_activation(name, **params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_unknown_activation_refused_as_jax():
    with pytest.raises(ValueError) as j_err:
        jseanet.get_activation("Swish")
    with pytest.raises(ValueError) as t_err:
        tseanet.get_activation("Swish")
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("dim,value,learnable", [(1, 1.0, True), (6, 0.5, True),
                                                 (1, 2.0, False)])
def test_scale_matches_jax(dim, value, learnable):
    x = np.random.RandomState(1).randn(2, 9, 6).astype(np.float32)
    jm = jseanet.Scale(dim=dim, value=value, learnable=learnable)
    tm = tseanet.Scale(dim, value, learnable)
    init_params(tm, torch.Generator())
    if learnable:
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        np.testing.assert_array_equal(tm.scale.detach().numpy(),
                                      np.asarray(params["scale"]))
    y_j, y_t = run_both(jm, tm, x)
    np.testing.assert_allclose(y_t, y_j, atol=1e-6, rtol=1e-6)


BLOCK = dict(kernel_size=3, dilations=(1, 1), activation="ELU", norm="weight_norm",
             causal=True, skip="identity", act_all=False, expansion=1, groups=-1,
             use_bias=True, res_scale=0.577, idx=1, zero_init=False,
             pad_mode="constant")
BLOCK_CASES = {
    "skip_1x1": dict(skip="1x1"),
    "skip_scale": dict(skip="scale"),
    "skip_exp_scale": dict(skip="exp_scale"),
    "skip_channelwise_scale": dict(skip="channelwise_scale"),
    "act_all": dict(act_all=True),
    "act_all_no_bias": dict(act_all=True, use_bias=False, skip="1x1"),
    "expansion": dict(expansion=2),
    "groups": dict(groups=4),
    "zero_init": dict(zero_init=True),
    "zero_init_no_res_scale": dict(zero_init=True, res_scale=None),
    "weight_standardization": dict(norm="weight_standardization", skip="1x1"),
    "spectral_norm": dict(norm="spectral_norm"),
    "layer_norm": dict(norm="layer_norm", skip="1x1"),
    "time_group_norm": dict(norm="time_group_norm"),
    "no_norm_alpha": dict(norm="none", activation="ELU"),
    "reflect_centred": dict(causal=False, pad_mode="reflect", dilations=(2, 1)),
    "replicate_causal": dict(pad_mode="replicate", kernel_size=5),
    "circular": dict(pad_mode="circular", dilations=(3, 1)),
    "gelu": dict(activation="GELU", act_all=True),
    "sigmoid": dict(activation="Sigmoid"),
    "relu": dict(activation="ReLU"),
    "leaky": dict(activation="LeakyReLU", skip="exp_scale"),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_resblock_option_matches_jax(case):
    kw = dict(BLOCK, **BLOCK_CASES[case])
    alpha = 0.5 if case == "no_norm_alpha" else 1.0
    x = np.random.RandomState(2).randn(2, 40, 8).astype(np.float32)
    jm = jseanet.SEANetResnetBlock(dim=8, activation_params={"alpha": alpha}, **kw)
    tm = tseanet.SEANetResnetBlock(8, alpha=alpha, **kw)
    y_j, y_t = run_both(jm, tm, x)
    np.testing.assert_allclose(y_t, y_j, **TOL)


def test_unknown_skip_refused():
    with pytest.raises(ValueError, match="unknown skip type"):
        tseanet.SEANetResnetBlock(8, skip="dense")


@pytest.mark.parametrize("skip,value", [("scale", 1.0), ("exp_scale", 0.0),
                                        ("channelwise_scale", 1.0)])
def test_block_gates_init_as_jax(skip, value):
    """skip_scale ones (exp_scale: zeros, through exp), res_scale_param
    zeros, and the 1x1 shortcut's leaves, as JAX's init makes them."""
    x = jnp.zeros((1, 10, 8))
    kw = dict(BLOCK, skip=skip, zero_init=True)
    params = jseanet.SEANetResnetBlock(dim=8, **kw).init(
        jax.random.PRNGKey(0), x)["params"]
    tm = tseanet.SEANetResnetBlock(8, **kw)
    init_params(tm, torch.Generator().manual_seed(0))
    for leaf in ("skip_scale", "res_scale_param"):
        np.testing.assert_array_equal(getattr(tm, leaf).detach().numpy(),
                                      np.asarray(params[leaf]))
    assert float(tm.skip_scale.detach()[0]) == value
    assert tm.skip_scale.shape[0] == (8 if skip == "channelwise_scale" else 1)


ENC = dict(dimension=32, n_filters=8, n_residual_layers=2, ratios=(4, 2),
           kernel_size=5, last_kernel_size=5, residual_kernel_size=3,
           dilation_base=1, causal=True, l2norm=True, use_bias=True,
           spec_compression="log", res_scale=0.577, skip="identity",
           zero_init=False)
ENC_CASES = {
    "wide_skips": dict(skip="1x1", zero_init=True, act_all=True,
                       activation="LeakyReLU", norm="weight_standardization",
                       causal=False, pad_mode="reflect", spec_compression="0.3",
                       spec_learnable=True),
    "grouped_gen": dict(skip="channelwise_scale", expansion=2, norm="layer_norm",
                        activation="GELU", pad_mode="replicate", dilation_base=2),
    "grouped_det": dict(skip="exp_scale", groups=8, norm="spectral_norm",
                        activation="ReLU", pad_mode="replicate", dilation_base=2),
    "grouped_loc": dict(skip="scale", norm="time_group_norm",
                        activation="Sigmoid", pad_mode="replicate"),
    "power_spec_learnable": dict(spec_compression="0.5", spec_learnable=True,
                                 zero_init=True),
    "no_compression": dict(spec_compression="", use_bias=False),
    "no_norm_alpha": dict(norm="none", alpha=0.5),
    "circular": dict(pad_mode="circular", causal=False),
}


def _jax_kw(kw):
    kw = dict(kw)
    alpha = kw.pop("alpha", 1.0)
    return dict(kw, activation_params={"alpha": alpha})


@pytest.mark.parametrize("case", sorted(ENC_CASES))
def test_encoder_option_matches_jax(case):
    kw = dict(ENC, **ENC_CASES[case])
    rng = np.random.RandomState(3)
    audio = (rng.randn(2, 8 * 9 + 3, 1) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (2, 16)).astype(np.float32)
    jenc = jseanet.SEANetEncoder(**_jax_kw(kw))
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(audio),
                                jnp.asarray(msg))["params"]
    flat = perturbed(params, 4)
    z_j = np.asarray(jax.jit(jenc.apply)({"params": _unflatten(flat)},
                                         jnp.asarray(audio), jnp.asarray(msg)))
    tenc = tseanet.SEANetEncoder(**kw)
    load_params(tenc, {f"e/{k}": v for k, v in flat.items()}, "e")
    with torch.no_grad():
        z_t = tenc(torch.from_numpy(audio.transpose(0, 2, 1).copy()),
                   torch.from_numpy(msg)).numpy().transpose(0, 2, 1)
    assert z_t.shape == z_j.shape
    np.testing.assert_allclose(z_t, z_j, **TOL)


DEC = dict(dimension=32, n_filters=12, n_residual_layers=2, ratios=(4, 2),
           kernel_size=5, last_kernel_size=5, residual_kernel_size=3,
           dilation_base=1, causal=True, use_bias=True, res_scale=0.577,
           final_activation="Tanh", skip="identity", zero_init=False)
DEC_CASES = {
    "wide_skips": dict(skip="1x1", zero_init=True, act_all=True,
                       activation="LeakyReLU", norm="weight_standardization",
                       causal=False, pad_mode="reflect"),
    "grouped": dict(skip="channelwise_scale", expansion=2, norm="layer_norm",
                    activation="GELU", pad_mode="replicate", dilation_base=2),
    "time_group_norm": dict(skip="scale", norm="time_group_norm",
                            final_activation="Sigmoid", groups=3),
    "no_norm_alpha": dict(norm="none", alpha=0.5, final_activation=None),
}


@pytest.mark.parametrize("case", sorted(DEC_CASES))
def test_decoder_option_matches_jax(case):
    kw = dict(DEC, **DEC_CASES[case])
    z = np.random.RandomState(5).randn(2, 6, 32).astype(np.float32)
    jdec = jseanet.SEANetDecoder(**_jax_kw(kw))
    params = jax.jit(jdec.init)(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
    flat = perturbed(params, 6)
    y_j = np.asarray(jax.jit(jdec.apply)({"params": _unflatten(flat)},
                                         jnp.asarray(z)))
    tdec = tseanet.SEANetDecoder(**kw)
    load_params(tdec, {f"d/{k}": v for k, v in flat.items()}, "d")
    with torch.no_grad():
        y_t = tdec(torch.from_numpy(z.transpose(0, 2, 1).copy())).numpy()
    np.testing.assert_allclose(y_t.transpose(0, 2, 1), y_j, **TOL)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_gate_matches_jax_fused_params(case):
    """``fusable()`` is JAX's ``_fused_params`` predicate (where the port's
    kernel takes the kernel size and the padding is zeros)."""
    kw = dict(BLOCK, **BLOCK_CASES[case])
    jm = jseanet.SEANetResnetBlock(dim=8, **kw)
    x = jnp.zeros((1, 12, 8))
    params = jm.init(jax.random.PRNGKey(0), x)
    jax_fuses = jm.apply(params, method=lambda m: m._fused_params() is not None)
    tm = tseanet.SEANetResnetBlock(8, **kw)
    expected = jax_fuses and kw["pad_mode"] == "constant"
    assert tm.fusable() == expected
