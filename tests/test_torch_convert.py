"""Reference ``.pth`` ingest and the WaveVerify constructor, on the CPU.

- ``tests/reference_checkpoint.py`` (numpy only) inverts the converters:
  inverter -> the JAX package's ``convert_torch_checkpoint`` gives back the
  original tree leaf for leaf (``g = ||v||`` as at init; f32 rounding of
  the fusion, 2e-7 relative).
- The port's ``convert_torch_checkpoint`` equals the JAX package's on every
  accepted form (atomic, composite, bare with ``module.`` / ``_orig_mod.``
  wrappers, un-stripped parametrizations, extra STFT buffers dropped with a
  warning), leaf for leaf within 1e-7.
- ``WaveVerify(pth)`` serves the JAX ``WaveVerify(pth)``'s bits, logits
  within 1e-5 (tiny config from a YAML, and r5's trained weights).
- The constructor: random init from a seed (the JAX tree's keys and
  shapes), config precedence and its WARNING, the port's checkpoint
  directories, no card (the JAX trainer's orbax directories are served in
  ``tests/test_torch_orbax.py``).
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from tests.reference_checkpoint import save_pth, to_reference_state_dicts
from tests.test_torch_trainer import TINY_YAML
from waveverify_tpu.api.core import WaveVerify as JWaveVerify
from waveverify_tpu.config import apply_model_config as japply_model_config
from waveverify_tpu.config import load_config as jload_config
from waveverify_tpu.convert import convert_torch_checkpoint as jconvert
from waveverify_tpu.train.state import create_train_state as jcreate
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_torch import WaveVerify, convert_torch_checkpoint
from waveverify_torch.config import TrainConfig, apply_model_config, load_config
from waveverify_torch.models import WatermarkModels
from waveverify_torch.modules.conv import init_params
from waveverify_torch.weights import export_params, read_npz, write_npz

torch.set_num_threads(2)

R5 = "weights/waveverify_demo_r5.npz"
NETS = ("generator", "detector", "locator")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(YAML path, port config, JAX config, flat weights): the tiny config's
    random init, its non-weight-norm leaves (biases, dense layers) redrawn
    so that every mapping carries information."""
    tmp = tmp_path_factory.mktemp("tiny")
    yml = tmp / "tiny.yml"
    yml.write_text(TINY_YAML)
    cfg, jcfg = load_config(yml), jload_config(str(yml))
    models = WatermarkModels(cfg)
    init_params(models, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    flat = {}
    for net in NETS:
        for k, v in export_params(getattr(models, net), net).items():
            if not k.endswith(("/v", "/g")):
                v = rng.randn(*v.shape).astype(np.float32) * 0.1
            flat[k] = v
    return yml, cfg, jcfg, flat


def _pth(tmp_path, flat, name="m.pth", parametrized=False, **kw):
    path = tmp_path / name
    save_pth(path, to_reference_state_dicts(flat, parametrized), **kw)
    return path


@pytest.mark.parametrize("parametrized", [False, True])
def test_inverter_round_trips_through_the_jax_converter(tmp_path, tiny, parametrized):
    _, _, jcfg, flat = tiny
    got = _flatten(jconvert(_pth(tmp_path, flat, parametrized=parametrized), jcfg))
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-7, atol=1e-9, err_msg=k)


FORMS = [dict(form="atomic"), dict(form="composite"),
         dict(form="bare", wrapper="module."), dict(form="bare", wrapper="_orig_mod."),
         dict(form="atomic", parametrized=True)]


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(map(str, f.values())))
def test_port_converter_equals_jax_on_each_form(tmp_path, tiny, form):
    _, cfg, jcfg, flat = tiny
    path = _pth(tmp_path, flat, **form)
    ours = _flatten(convert_torch_checkpoint(path, cfg))
    ref = _flatten(jconvert(path, jcfg))
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == np.float32
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-7, err_msg=k)


def test_extra_stft_buffers_are_dropped_with_a_warning(tmp_path, tiny, caplog):
    _, cfg, jcfg, flat = tiny
    sds = to_reference_state_dicts(flat)
    for net in NETS:
        sds[net]["encoder.spec_blocks.0.spec.weight"] = np.ones((66, 1, 64), np.float32)
        sds[net]["encoder.spec_blocks.0.spec.window"] = np.ones(64, np.float32)
    sds["discriminator"] = {"mpd.0.conv.weight": np.ones((2, 1, 5, 1), np.float32)}
    path = tmp_path / "buffers.pth"
    save_pth(path, sds)
    with caplog.at_level(logging.WARNING, logger="waveverify_torch.convert"):
        ours = _flatten(convert_torch_checkpoint(path, cfg))
    dropped = [r.getMessage() for r in caplog.records if "dropping" in r.getMessage()]
    assert len(dropped) == 3 and all("spec_block_0/stft" in m for m in dropped)
    ref = _flatten(jconvert(path, jcfg))
    assert set(ours) == set(ref) == set(flat)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-7, err_msg=k)


def test_converter_raises_on_missing_or_misshapen_entries(tmp_path, tiny):
    _, cfg, _, flat = tiny
    sds = to_reference_state_dicts(flat)
    del sds["locator"]
    save_pth(tmp_path / "no_loc.pth", sds)
    with pytest.raises(ValueError, match="locator"):
        convert_torch_checkpoint(tmp_path / "no_loc.pth", cfg)
    sds = to_reference_state_dicts(flat)
    sds["detector"]["last_layer.weight"] = np.ones((3, 3, 1), np.float32)
    save_pth(tmp_path / "shape.pth", sds)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert_torch_checkpoint(tmp_path / "shape.pth", cfg)


def _logits(wv, x, jax_side=False):
    if jax_side:
        return tuple(np.asarray(f(wv.params[n], x)) for n, f in
                     (("detector", wv.models.apply_detector),
                      ("locator", wv.models.apply_locator)))
    with torch.no_grad():
        t = torch.from_numpy(np.array(x))
        return (wv.models.apply_detector(t).numpy(), wv.models.apply_locator(t).numpy())


def _serve_equal(tw, jw, t, seed, rtol=0.0):
    """Watermarked audio and logits within 1e-5 (plus ``rtol``); bits equal
    wherever the JAX time-mean probability is more than 1e-3 from 0.5."""
    rng = np.random.RandomState(seed)
    audio = (rng.randn(2, t) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (2, 16)).astype(np.float32)
    w_t, w_j = tw.embed_batch(audio, bits), jw.embed_batch(audio, bits)
    np.testing.assert_allclose(w_t, w_j, atol=1e-5)
    ours, ref = _logits(tw, w_j), _logits(jw, w_j, jax_side=True)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=rtol)
    probs = 1 / (1 + np.exp(-ref[0].astype(np.float64)))
    sure = np.abs(probs.mean(axis=1) - 0.5) > 1e-3
    b_t, b_j = tw.detect_batch(w_j)[0], jw.detect_batch(w_j)[0]
    assert (b_t == b_j)[sure].all() and sure.any()


def test_waveverify_serves_a_pth_as_jax_does(tmp_path, tiny):
    yml, _, _, flat = tiny
    path = _pth(tmp_path, flat)
    tw = WaveVerify(path, config_path=yml, device="cpu")
    jw = JWaveVerify(path, config_path=str(yml), precision="highest")
    _serve_equal(tw, jw, 3200, 2)


def test_waveverify_serves_r5_as_a_pth(tmp_path):
    """r5's trained weights (g != ||v||) through the reference layout: the
    same bits as the JAX package serving the same file; logits within 1e-5
    + 1e-5 relative of it and of the port serving the .npz (r5's logits
    reach ~9, where f32 rounding of the fused kernels alone is ~1e-5;
    measured 1.1e-6 relative)."""
    flat, snap = read_npz(R5)
    path = tmp_path / "r5.pth"
    save_pth(path, to_reference_state_dicts(flat))
    tw = WaveVerify(path, config=apply_model_config(TrainConfig(), snap), device="cpu")
    jcfg = japply_model_config(jload_config(None), snap)
    jw = JWaveVerify(path, config=jcfg, precision="highest")
    _serve_equal(tw, jw, 4800, 3, rtol=1e-5)
    npz = WaveVerify(R5, device="cpu")
    x = (np.random.RandomState(4).randn(1, 4800) * 0.1).astype(np.float32)
    for a, b in zip(_logits(tw, x), _logits(npz, x)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _exported(wv):
    return {k: v for net in NETS for k, v in
            export_params(getattr(wv.models, net), net).items()}


def test_random_init_follows_the_seed_and_the_jax_tree(tiny):
    _, cfg, jcfg, _ = tiny
    a, b, c = (_exported(WaveVerify(None, config=cfg, seed=s, device="cpu"))
               for s in (5, 5, 6))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert any(not np.array_equal(a[k], c[k]) for k in a if k.endswith("/v"))
    st = jax.eval_shape(lambda k: jcreate(jcfg, k, JModels.from_config(jcfg)),
                        jax.random.PRNGKey(0))
    ref = {f"{net}/{k}": tuple(v.shape)
           for net in NETS for k, v in _flatten_shapes(st.wm_params[net]).items()}
    assert {k: v.shape for k, v in a.items()} == ref


def _flatten_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten_shapes(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_random_init_warns(caplog, tiny):
    with caplog.at_level(logging.WARNING):
        WaveVerify(None, config=tiny[1], device="cpu")
    assert any("randomly initialized" in r.getMessage() for r in caplog.records)


def test_config_precedence_as_jax(tmp_path, caplog, tiny):
    """A snapshot overrides the YAML's model sections with a WARNING naming
    them; an explicit ``config`` wins over the snapshot, as in JAX."""
    yml = tiny[0]
    with caplog.at_level(logging.WARNING):
        tw = WaveVerify(R5, config_path=yml, device="cpu")
    msgs = [r.getMessage() for r in caplog.records if "overrides" in r.getMessage()]
    assert msgs and "Generator" in msgs[0]
    jw = JWaveVerify(R5, config_path=str(yml), precision="highest")
    assert tw.config.generator.msg_mode == jw.config.generator.msg_mode == "carrier"
    assert tw.config.generator.channels_enc == jw.config.generator.channels_enc == 64
    assert tw.config.batch_size == jw.config.batch_size == 4  # the YAML's
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        with pytest.raises((KeyError, ValueError)):
            # the tiny architecture cannot hold r5's weights: the explicit
            # config was not overridden
            WaveVerify(R5, config=tiny[1], device="cpu")
    assert not [r for r in caplog.records if "overrides" in r.getMessage()]


def _port_ckpt(tmp_path, flat, cfg_dict):
    tag = tmp_path / "run" / "latest"
    tag.mkdir(parents=True)
    write_npz(tag / "weights.npz", flat, cfg_dict)
    (tag / "meta.json").write_text(json.dumps({"step": 3, "model_config": cfg_dict}))
    (tag / "state.pt").write_bytes(b"")
    return tag


def test_port_checkpoint_dirs_serve_their_weights(tmp_path):
    flat, snap = read_npz(R5)
    tag = _port_ckpt(tmp_path, flat, snap)
    ref = WaveVerify(tag / "weights.npz", device="cpu")
    rng = np.random.RandomState(5)
    audio = (rng.randn(2, 4800) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (2, 16)).astype(np.float32)
    want = ref.embed_batch(audio, bits)
    for path in (tag, tag.parent):
        wv = WaveVerify(path, device="cpu")
        assert wv.config == ref.config
        np.testing.assert_array_equal(wv.embed_batch(audio, bits), want)
        np.testing.assert_array_equal(wv.detect_batch(want)[1],
                                      ref.detect_batch(want)[1])


def test_unknown_paths_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        WaveVerify(tmp_path, device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WaveVerify()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WaveVerify(R5)
