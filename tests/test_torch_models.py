"""Port generator, detector and the embed+detect program against the JAX
package: at a small config with random params, and at full width on the
committed r5 checkpoint (f32 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu.config import DetectorConfig as JDetectorConfig
from waveverify_tpu.config import GeneratorConfig as JGeneratorConfig
from waveverify_tpu.config import TrainConfig as JTrainConfig
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_torch.config import DetectorConfig, GeneratorConfig, TrainConfig
from waveverify_torch.models import (
    WatermarkModels,
    detector_bits,
    detector_confidence,
    detector_postprocess,
)
from waveverify_torch.serve import embed_detect
from waveverify_torch.weights import flatten, load_params, read_npz

torch.set_num_threads(2)

R5 = "weights/waveverify_demo_r5.npz"
SMALL = dict(dimension=32, channels_enc=8, kernel_size=5, last_kernel_size=5,
             residual_kernel_size=5, dilation_base=1, skip="identity",
             causal=True, encoder_l2norm=True, bias=True,
             spec_compression="log", zero_init=False)
GEN = dict(channels_dec=12, n_residual_enc=2, n_residual_dec=3,
           msg_mode="carrier", film_carrier_gain=0.5, film_gamma_bias=1.0,
           latent_carrier_gain=0.2, **SMALL)
DET = dict(n_residual_enc=2, output_dim=8, **SMALL)


def _randomize(params, seed):
    rng = np.random.RandomState(seed)
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    for k, v in flat.items():
        if k.split("/")[-1] in ("b", "bias"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.split("/")[-1] == "kernel":
            flat[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
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


@pytest.fixture(scope="module")
def small():
    jcfg = JTrainConfig(generator=JGeneratorConfig(**GEN),
                        detector=JDetectorConfig(**DET))
    jm = JModels.from_config(jcfg)
    audio = np.zeros((1, 960), np.float32)
    msg = np.zeros((1, 16), np.float32)
    gp = jax.jit(lambda k: jm.generator.init(k, audio[..., None], msg))(
        jax.random.PRNGKey(0))["params"]
    dp = jax.jit(lambda k: jm.detector.init(k, audio[..., None]))(
        jax.random.PRNGKey(1))["params"]
    flat = {**{f"generator/{k}": v for k, v in _randomize(gp, 2).items()},
            **{f"detector/{k}": v for k, v in _randomize(dp, 3).items()}}
    tm = WatermarkModels(TrainConfig(generator=GeneratorConfig(**GEN),
                                     detector=DetectorConfig(**DET)))
    load_params(tm.generator, flat, "generator")
    load_params(tm.detector, flat, "detector")
    jparams = _unflatten(flat)
    return jm, jparams, tm


def _inputs(b, t, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, t) * 0.1).astype(np.float32),
            rng.randint(0, 2, (b, 16)).astype(np.float32))


def test_small_generator_matches_jax(small):
    jm, jp, tm = small
    audio, msg = _inputs(2, 1000)  # not a hop multiple: pad, then trim
    r_j = np.asarray(jax.jit(jm.apply_generator)(jp["generator"], audio, msg))
    with torch.no_grad():
        r_t = tm.apply_generator(torch.from_numpy(audio), torch.from_numpy(msg))
    assert r_t.shape == r_j.shape == (2, 1000)
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=1e-5, rtol=1e-4)


def test_small_detector_matches_jax(small):
    jm, jp, tm = small
    audio, _ = _inputs(2, 1000, seed=1)
    l_j = np.asarray(jax.jit(jm.apply_detector)(jp["detector"], audio))
    with torch.no_grad():
        l_t = tm.apply_detector(torch.from_numpy(audio)).numpy()
    assert l_t.shape == l_j.shape == (2, 1000, 16)
    np.testing.assert_allclose(l_t, l_j, atol=1e-4, rtol=1e-4)


def test_small_embed_detect_matches_jax(small):
    jm, jp, tm = small
    audio, msg = _inputs(3, 960, seed=2)

    @jax.jit
    def jax_program(params, audio, msg):  # bench.py's _build program
        residual = jm.apply_generator(params["generator"], audio, msg)
        watermarked = residual.astype(jnp.float32) + audio
        logits = jm.apply_detector(params["detector"], watermarked)
        return watermarked, jnp.mean(jax.nn.sigmoid(logits), axis=1)

    w_j, p_j = map(np.asarray, jax_program(jp, audio, msg))
    w_t, p_t = embed_detect(tm, torch.from_numpy(audio), torch.from_numpy(msg))
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=1e-5, rtol=1e-4)
    # bf16 activations: finite, audio stays f32
    w16, p16 = embed_detect(tm, torch.from_numpy(audio), torch.from_numpy(msg),
                            "bfloat16")
    assert w16.dtype == torch.float32 and p16.dtype == torch.float32
    assert bool(torch.isfinite(w16).all()) and bool(torch.isfinite(p16).all())


def test_r5_full_width_parity_f32():
    """r5 at full width, batch 2 x 16000, f32 on the CPU. Tolerances: the
    residual 1e-5 absolute (measured ~1e-6); the logits 2e-4 absolute on
    magnitudes up to ~40 (measured ~2.5e-5, a relative 1e-6). Bits must be
    identical wherever the time-mean probability is > 1e-3 from 0.5."""
    from waveverify_tpu.api.core import WaveVerify as JWaveVerify

    jw = JWaveVerify(R5)
    flat, snap = read_npz(R5)
    from waveverify_torch.config import apply_model_config

    tm = WatermarkModels(apply_model_config(TrainConfig(), snap))
    load_params(tm.generator, flat, "generator")
    load_params(tm.detector, flat, "detector")
    audio, msg = _inputs(2, 16000, seed=5)
    r_j = np.asarray(jax.jit(jw.models.apply_generator)(
        jw.params["generator"], audio, msg))
    l_j = np.asarray(jax.jit(jw.models.apply_detector)(
        jw.params["detector"], audio + r_j))
    with torch.no_grad():
        r_t = tm.apply_generator(torch.from_numpy(audio), torch.from_numpy(msg))
        l_t = tm.apply_detector(torch.from_numpy(audio) + r_t)
    r_t, l_t = r_t.numpy(), l_t.numpy()
    dr, dl = np.abs(r_t - r_j).max(), np.abs(l_t - l_j).max()
    print(f"r5 f32 max |residual dev| {dr:.3e}, max |logit dev| {dl:.3e}")
    assert dr <= 1e-5 and dl <= 2e-4
    p_j = (1.0 / (1.0 + np.exp(-l_j.astype(np.float64)))).mean(axis=1)
    p_t = (1.0 / (1.0 + np.exp(-l_t.astype(np.float64)))).mean(axis=1)
    sure = np.abs(p_j - 0.5) > 1e-3
    assert sure.any()
    np.testing.assert_array_equal((p_t > 0.5)[sure], (p_j > 0.5)[sure])


def test_decision_helpers_match_jax():
    from waveverify_tpu.models import detector as jdet

    rng = np.random.RandomState(7)
    logits = (rng.randn(3, 50, 16) * 2).astype(np.float32)
    lt = torch.from_numpy(logits)
    np.testing.assert_array_equal(detector_bits(lt).numpy(),
                                  np.asarray(jdet.detector_bits(logits)))
    np.testing.assert_allclose(detector_confidence(lt).numpy(),
                               np.asarray(jdet.detector_confidence(logits)),
                               atol=1e-6)
    bits_t, probs_t = detector_postprocess(lt)
    bits_j, probs_j = jdet.detector_postprocess(logits)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), atol=1e-6)
