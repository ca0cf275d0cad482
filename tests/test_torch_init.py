"""The port's random initialisation: the parameter tree has exactly the
names and shapes of the JAX package's ``create_train_state`` at the
conf/base.yml width, and each layer follows the JAX package's initialiser
(kaiming-normal ``v`` with its fan and gain, ``g = ||v||``, zero biases,
truncated-normal(0.02) Dense kernels, the l2norm projection's N(0, 1)
bias)."""

import math

import jax
import pytest
import torch

from waveverify_tpu.config import GeneratorConfig as JGeneratorConfig
from waveverify_tpu.config import TrainConfig as JTrainConfig
from waveverify_tpu.train.state import create_train_state as jcreate
from waveverify_torch.config import GeneratorConfig, TrainConfig
from waveverify_torch.models import WatermarkModels
from waveverify_torch.modules.conv import (
    NormConv1d,
    NormConv2d,
    NormConvTranspose1d,
    init_params,
)
from waveverify_torch.weights import export_params

torch.set_num_threads(2)

NETS = ("generator", "detector", "locator", "discriminator")
# std of a unit normal truncated at +-2
TRUNC_STD = 0.8796256610342398


@pytest.fixture(scope="module")
def models():
    m = WatermarkModels(TrainConfig(), discriminator=True)
    init_params(m, torch.Generator().manual_seed(0))
    return m


@pytest.fixture(scope="module")
def jax_tree():
    """Shapes of the JAX package's initial parameters (traced, not run)."""
    st = jax.eval_shape(lambda k: jcreate(JTrainConfig(), k), jax.random.PRNGKey(0))
    return dict(st.wm_params, discriminator=st.disc_params)


@pytest.mark.parametrize("net", NETS)
def test_tree_matches_jax_create_train_state(models, jax_tree, net):
    tree = jax_tree
    ref = {}

    def walk(node, path):
        for k, v in node.items():
            if hasattr(v, "shape"):
                ref["/".join(path + [k])] = tuple(v.shape)
            else:
                walk(v, path + [k])

    walk(tree[net], [net])
    ours = {k: v.shape for k, v in export_params(getattr(models, net), net).items()}
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k] == ref[k], k


def _owners(module):
    for name, m in module.named_modules():
        if isinstance(m, (NormConv1d, NormConvTranspose1d, NormConv2d)):
            yield name, m


@pytest.mark.parametrize("net", NETS)
def test_conv_init_rules(models, net):
    """v ~ N(0, gain^2 / fan_in) with fan_in = prod(v.shape[1:]); g equal to
    ||v|| per leading index; zero biases."""
    checked = 0
    for name, m in _owners(getattr(models, net)):
        v = m.v.detach()
        fan = math.prod(v.shape[1:])
        gain = math.sqrt(2.0) if m.nonlinearity == "relu" else 1.0
        std = gain / math.sqrt(fan)
        if v.numel() >= 4000:
            assert abs(float(v.std()) / std - 1) < 0.08, (name, float(v.std()), std)
            assert abs(float(v.mean())) < 0.1 * std, name
            checked += 1
        if m.g is not None:
            norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim()))))
            torch.testing.assert_close(m.g.detach(), norm, rtol=1e-6, atol=0,
                                       msg=name)
            # so the effective kernel is v itself
            torch.testing.assert_close(m.weight().detach(), v, rtol=1e-5, atol=1e-7)
        if m.b is not None:
            assert torch.all(m.b == 0), name
    assert checked > 0


def test_relu_gain_is_where_jax_puts_it(models):
    enc = models.generator.encoder
    relu = {"block_0_0.block_0_pw", "down_0_expand", "post_dw"}
    linear = {"conv_pre", "block_0_0.block_0_dw", "down_0_dw", "spec_block_0.proj",
              "post_proj.conv"}
    for name in relu | linear:
        conv = enc.get_submodule(name).conv
        assert conv.nonlinearity == ("relu" if name in relu else "linear"), name
    dec = models.generator.decoder
    assert dec.up_0_dw.convtr.nonlinearity == "relu"
    assert dec.conv_out.conv.nonlinearity == "relu"
    assert dec.up_0_proj.conv.nonlinearity == "linear"


@pytest.mark.parametrize("net", ["generator", "detector", "locator"])
def test_dense_and_bias_init_rules(models, net):
    enc = getattr(models, net).encoder
    for layer in [enc.msg_in] + [getattr(enc, f"msg_hidden_{i}") for i in range(2)]:
        w = layer.weight.detach()
        assert float(w.abs().max()) <= 0.04
        assert abs(float(w.std()) / (0.02 * TRUNC_STD) - 1) < 0.1
        assert torch.all(layer.bias == 0)
    for i in range(4):
        for j in range(4):
            film = getattr(enc, f"film_{i}_{j}", None)
            if film is None:
                continue
            assert float(film.gamma.weight.detach().abs().max()) <= 0.04
            assert torch.all(film.gamma.bias == 0) and torch.all(film.beta.bias == 0)
    b = enc.post_proj.b.detach()  # l2norm on: N(0, 1)
    assert 0.7 < float(b.std()) < 1.3 and abs(float(b.mean())) < 0.3


def test_film_gamma_bias_initialises_gamma():
    m = WatermarkModels(TrainConfig(generator=GeneratorConfig(film_gamma_bias=1.0)))
    init_params(m, torch.Generator().manual_seed(0))
    assert torch.all(m.generator.encoder.film_0_0.gamma.bias == 1.0)
    assert torch.all(m.generator.encoder.film_0_0.beta.bias == 0.0)
    # the JAX generator takes the same field
    assert JGeneratorConfig(film_gamma_bias=1.0).film_gamma_bias == 1.0


def test_init_is_a_function_of_the_seed(models):
    again = WatermarkModels(TrainConfig(), discriminator=True)
    init_params(again, torch.Generator().manual_seed(0))
    other = WatermarkModels(TrainConfig(), discriminator=True)
    init_params(other, torch.Generator().manual_seed(1))
    for (n, p), q, r in zip(models.named_parameters(), again.parameters(),
                            other.parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(models.generator.encoder.conv_pre.conv.v,
                           other.generator.encoder.conv_pre.conv.v)


def test_r5_architecture_tree_matches_the_r5_weights():
    """At the r5 checkpoint's own architecture (its __config__ snapshot:
    carrier message mode, FiLM and latent carriers), the initialised tree of
    the three networks has exactly the committed file's names and shapes,
    so a warm start from it consumes every entry."""
    from waveverify_torch.config import apply_model_config
    from waveverify_torch.weights import read_npz

    flat, snap = read_npz("weights/waveverify_demo_r5.npz")
    m = WatermarkModels(apply_model_config(TrainConfig(), snap))
    init_params(m, torch.Generator().manual_seed(0))
    ours = {}
    for net in ("generator", "detector", "locator"):
        ours.update({k: v.shape for k, v in export_params(getattr(m, net), net).items()})
    assert ours == {k: v.shape for k, v in flat.items()}
