"""The three option variants of ``tests/variants.py`` at the tiny size
(dimension 32, n_filters 8) against the JAX package, f32 on the CPU:

- the Generator, Detector and Locator on the same parameters (the port's
  random init, its zero-init gates and norm biases moved off zero), atol
  1e-4, rtol 1e-4;
- the random-init tree equal in names and shapes to ``create_train_state``'s,
  and the leaves JAX initialises to constants (gains, skip and residual
  scales, norm scales and biases, the STFT basis, zero biases) equal in
  value;
- a reference ``.pth`` made by ``tests/reference_checkpoint.py`` from those
  parameters, converted by the port and served equal to JAX on the
  parameters it was made from (atol 1e-4, rtol 1e-4);
- the chain route: the port hands a chain to the kernel's wrapper exactly
  where the JAX package's gate (``_fused_params``, ``can_fuse``) hands it to
  its Pallas kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import variants
from tests.reference_checkpoint import save_pth, to_reference_state_dicts
from tests.torch_jax_bridge import jax_params, tiny_configs
from tests.train_parity import _port_state
from waveverify_tpu.ops import pallas_kernels
from waveverify_tpu.train.state import create_train_state as jcreate_train_state
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_torch.convert import convert_torch_checkpoint
from waveverify_torch.models import WatermarkModels
from waveverify_torch.modules import seanet as tseanet
from waveverify_torch.modules.conv import init_params
from waveverify_torch.weights import export_params, flatten, load_params

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = sorted(variants.VARIANTS)
NETS = variants.NETS


def _configs(name):
    return tuple(variants.apply(c, name) for c in tiny_configs(2, remat=False))


def _inputs():
    rng = np.random.RandomState(11)
    audio = (rng.randn(2, 3200) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (2, 16)).astype(np.float32)
    return audio, msg


def _port_outputs(models, audio, msg):
    a, m = torch.from_numpy(audio), torch.from_numpy(msg)
    with torch.no_grad():
        return {"generator": models.apply_generator(a, m).numpy(),
                "detector": models.apply_detector(a).numpy(),
                "locator": models.apply_locator(a).numpy()}


def _jax_outputs(jmodels, wm, audio, msg):
    return {"generator": np.asarray(jax.jit(jmodels.apply_generator)(
                wm["generator"], audio, msg)),
            "detector": np.asarray(jax.jit(jmodels.apply_detector)(
                wm["detector"], audio)),
            "locator": np.asarray(jax.jit(jmodels.apply_locator)(
                wm["locator"], audio))}


@pytest.fixture(scope="module", params=NAMES)
def variant(request):
    """(name, JAX config, port config, port models, JAX outputs)."""
    jcfg, tcfg = _configs(request.param)
    models = _port_state(tcfg).models
    wm, _ = jax_params(models)
    audio, msg = _inputs()
    return (request.param, jcfg, tcfg, models,
            _jax_outputs(JModels.from_config(jcfg), wm, audio, msg))


@pytest.mark.parametrize("net", NETS)
def test_forward_matches_jax(variant, net):
    _, _, _, models, ref = variant
    ours = _port_outputs(models, *_inputs())
    assert ours[net].shape == ref[net].shape
    assert np.isfinite(ours[net]).all()
    np.testing.assert_allclose(ours[net], ref[net], **TOL)


CONSTANT_LEAVES = ("skip_scale", "res_scale_param", "scale_param", "bias", "b")


@pytest.mark.parametrize("name", NAMES)
def test_random_init_tree_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0))
    trees = dict(jstate.wm_params, discriminator=jstate.disc_params)
    models = WatermarkModels(tcfg, discriminator=True)
    init_params(models, torch.Generator().manual_seed(0))
    for net in NETS + ("discriminator",):
        ref = flatten(jax.tree_util.tree_map(np.asarray, trees[net]))
        ours = {k.split("/", 1)[1]: v for k, v in
                export_params(getattr(models, net), net).items()}
        assert {k: v.shape for k, v in ours.items()} == {
            k: v.shape for k, v in ref.items()}, net
        for k, v in ref.items():
            leaf = k.split("/")[-1]
            ws_gain = leaf == "g" and v.ndim > 1
            if (leaf in CONSTANT_LEAVES and not k.endswith("post_proj/b")
                    or ws_gain or "/norm/" in k or k.endswith("stft/weight")):
                np.testing.assert_array_equal(ours[k], v, err_msg=f"{net}/{k}")


def test_variant_trees_carry_their_options():
    """Each variant puts the leaves its options own into the tree: the
    shortcut and gates of wide_skips (and the learned basis, generator
    only), the skip scales and norm modules of grouped, no weight-norm
    gain under kernel_alpha."""
    trees = {n: {net: set(export_params(getattr(WatermarkModels(_configs(n)[1]), net),
                                        net)) for net in NETS} for n in NAMES}
    wide = trees["wide_skips"]
    assert any(k.endswith("block_0_0/shortcut/conv/g") for k in wide["detector"])
    assert any(k.endswith("res_scale_param") for k in wide["locator"])
    assert any(k.endswith("spec_post/scale_param") for k in wide["generator"])
    assert any(k.endswith("stft/weight") for k in wide["generator"])
    assert not any(k.endswith("stft/weight") for k in wide["detector"])
    grouped = trees["grouped"]
    assert any(k.endswith("conv/norm/LayerNorm_0/scale") for k in grouped["generator"])
    assert any(k.endswith("conv/norm/scale") for k in grouped["locator"])
    assert any(k.endswith("skip_scale") for k in grouped["detector"])
    assert not any(k.endswith("/g") for k in grouped["detector"])
    assert not any(k.endswith("/g") for net in NETS for k in trees["kernel_alpha"][net])


def test_reference_pth_serves_as_jax(variant, tmp_path):
    name, _, tcfg, models, ref = variant
    flat = {}
    for net in NETS:
        flat.update(export_params(getattr(models, net), net))
    path = tmp_path / f"{name}.pth"
    save_pth(path, to_reference_state_dicts(flat, cfg=tcfg))
    tree = convert_torch_checkpoint(path, tcfg)
    served = WatermarkModels(tcfg)
    for net in NETS:
        load_params(getattr(served, net), flatten({net: tree[net]}), net)
    ours = _port_outputs(served, *_inputs())
    for net in NETS:
        np.testing.assert_allclose(ours[net], ref[net], err_msg=net, **TOL)


def _jax_chain_calls(jcfg, wm, audio, msg, monkeypatch):
    """The (C, M) of each chain JAX's gate hands to its Pallas kernel, per
    network, with Pallas switched on; the recorder returns its input (the
    route depends on shapes and config alone)."""
    calls = []
    monkeypatch.setattr(pallas_kernels, "pallas_enabled", lambda: True)
    monkeypatch.setattr(pallas_kernels, "fused_resblock_chain",
                        lambda x, slots, **k: calls.append((x.shape[-1], len(slots))) or x)
    monkeypatch.setattr(pallas_kernels, "fused_resblock",
                        lambda x, *a, **k: calls.append((x.shape[-1], 1)) or x)
    jmodels = JModels.from_config(jcfg)
    out = {}
    for net, run in (("generator", lambda: jmodels.apply_generator(wm["generator"], audio, msg)),
                     ("detector", lambda: jmodels.apply_detector(wm["detector"], audio)),
                     ("locator", lambda: jmodels.apply_locator(wm["locator"], audio))):
        calls.clear()
        run()
        out[net] = sorted(calls)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_chain_route_matches_jax_gate(name, monkeypatch):
    jcfg, tcfg = _configs(name)
    models = _port_state(tcfg).models
    wm, _ = jax_params(models)
    audio, msg = _inputs()
    audio, msg = audio[:1, :640], msg[:1]
    ref = _jax_chain_calls(jcfg, wm, jnp.asarray(audio), jnp.asarray(msg),
                           monkeypatch)
    calls = []
    fused = tseanet.fused_resblock_chain
    monkeypatch.setattr(tseanet, "fused_resblock_chain", lambda x, w, **k: calls.append(
        (x.shape[1], len(k["prescales"]))) or fused(x, w, **k))
    ours = {}
    a, m = torch.from_numpy(audio), torch.from_numpy(msg)
    with torch.no_grad():
        for net, run in (("generator", lambda: models.apply_generator(a, m)),
                         ("detector", lambda: models.apply_detector(a)),
                         ("locator", lambda: models.apply_locator(a))):
            calls.clear()
            run()
            ours[net] = sorted(calls)
    assert ours == ref
    assert [net for net in NETS if ref[net]] == list(variants.KERNEL_NETS[name])
