"""The port's locator and ``locate`` against the JAX package, f32 on the CPU.

Tolerances: presence probabilities within 1e-5 absolute (the sigmoid of
logits that agree to a relative 1e-6), and identical ``> 0.5`` decisions
wherever the JAX probability is more than 1e-3 from 0.5. At the small
config with random weights the logits are held to 1e-4 absolute, 1e-4
relative, as the detector's are in ``test_torch_models.py``."""

import jax
import numpy as np
import pytest
import torch

from waveverify_tpu.api.core import WaveVerify as JWaveVerify
from waveverify_tpu.config import LocatorConfig as JLocatorConfig
from waveverify_tpu.models.locator import Locator as JLocator
from waveverify_torch import WaveVerify
from waveverify_torch.api.core import _next_bucket
from waveverify_torch.config import LocatorConfig, TrainConfig, apply_model_config
from waveverify_torch.models import Locator, WatermarkModels
from waveverify_torch.ops.resblock_chain import launches_per_chain
from waveverify_torch.weights import flatten, load_params, read_npz

torch.set_num_threads(2)

R5 = "weights/waveverify_demo_r5.npz"
SMALL = dict(dimension=32, channels_enc=8, kernel_size=5, last_kernel_size=5,
             residual_kernel_size=5, dilation_base=1, skip="identity",
             causal=True, encoder_l2norm=True, bias=True,
             spec_compression="log", zero_init=False, n_residual_enc=2,
             output_dim=8)
PROB_ATOL = 1e-5
MARGIN = 1e-3


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def _assert_same_decisions(p_t, p_j, margin=MARGIN):
    sure = np.abs(p_j - 0.5) > margin
    assert sure.any()
    np.testing.assert_array_equal((p_t > 0.5)[sure], (p_j > 0.5)[sure])


@pytest.fixture(scope="module")
def r5_pair():
    return JWaveVerify(R5), WaveVerify(R5, device="cpu")


def test_small_locator_matches_jax():
    jl = JLocator(config=JLocatorConfig(**SMALL))
    audio = (np.random.RandomState(0).randn(2, 1000) * 0.1).astype(np.float32)
    params = jax.jit(jl.init)(jax.random.PRNGKey(4), audio[..., None])["params"]
    rng = np.random.RandomState(5)
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    for k, v in flat.items():  # non-zero biases, FiLM and MLP weights too
        if k.split("/")[-1] in ("b", "bias"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    tl = Locator(LocatorConfig(**SMALL))
    consumed = load_params(tl, {f"locator/{k}": v for k, v in flat.items()},
                           "locator")
    assert len(consumed) == len(flat)
    assert any("/film_" in k for k in consumed)
    assert any("/msg_in/" in k for k in consumed)
    jparams = {}
    for k, v in flat.items():
        node = jparams
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    l_j = np.asarray(jax.jit(jl.apply)({"params": jparams}, audio[..., None]))
    with torch.no_grad():
        l_t = tl(torch.from_numpy(audio)[:, None, :]).numpy()
    assert l_t.shape == l_j.shape == (2, 1000, 1)
    np.testing.assert_allclose(l_t, l_j, atol=1e-4, rtol=1e-4)


def test_r5_locator_keys_are_all_consumed():
    flat, snap = read_npz(R5)
    models = WatermarkModels(apply_model_config(TrainConfig(), snap))
    consumed = load_params(models.locator, flat, "locator")
    assert consumed == {k for k in flat if k.startswith("locator/")}
    assert models.locator.config.strides == (8, 4)
    # the locator's two chains are one block each, at C = 32 and 64
    assert [launches_per_chain(c, 1) for c in (32, 64)] == [1, 1]


def test_r5_locator_full_width_parity_f32(r5_pair):
    """r5 at full width, batch 2 x 16000."""
    jw, tw = r5_pair
    audio = (np.random.RandomState(6).randn(2, 16000) * 0.1).astype(np.float32)
    l_j = np.asarray(jax.jit(jw.models.apply_locator)(jw.params["locator"], audio))
    with torch.no_grad():
        l_t = tw.models.apply_locator(torch.from_numpy(audio)).numpy()
    assert l_t.shape == l_j.shape == (2, 16000)
    p_j, p_t = _sigmoid(l_j), _sigmoid(l_t)
    dp = np.abs(p_t - p_j).max()
    print(f"r5 locator f32 max |logit dev| {np.abs(l_t - l_j).max():.3e}, "
          f"max |prob dev| {dp:.3e}")
    assert dp <= PROB_ATOL
    _assert_same_decisions(p_t, p_j)


def test_locate_array_off_bucket_length(r5_pair):
    jw, tw = r5_pair
    rng = np.random.RandomState(7)
    audio = (rng.randn(9001) * 0.1).astype(np.float32)
    assert _next_bucket(9001) != 9001
    m_j = jw.locate_array(audio)
    m_t = tw.locate_array(audio)
    assert m_t.dtype == np.float32 and m_t.shape == m_j.shape == (9001,)
    assert np.abs(m_t - m_j).max() <= PROB_ATOL
    _assert_same_decisions(m_t, m_j)


def test_locate_reads_a_wav(r5_pair, tmp_path):
    _, tw = r5_pair
    from waveverify_torch.api.audio_io import save_audio

    audio = (np.random.RandomState(8).randn(6000) * 0.1).astype(np.float32)
    save_audio(audio, tmp_path / "clip.wav")
    mask = tw.locate(tmp_path / "clip.wav")
    assert mask.shape == (6000,) and np.isfinite(mask).all()
    assert ((mask >= 0.0) & (mask <= 1.0)).all()
