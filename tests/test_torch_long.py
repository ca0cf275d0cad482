"""The port's chunked long-audio path against its own monolithic run and
against the JAX package's chunked path, f32 on the CPU at a small config.

The chunk geometry is shrunk as in ``tests/test_api.py``'s chunked test
(windows of 6400 + 6400 samples over a 2 s clip), so the path runs four
windows. Tolerance: atol 2e-5, rtol 1e-4, the JAX test's own. The JAX
weights (random init from seed 0) reach the port through
``save_weights_npz(..., dtype=np.float32, config=cfg)``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu.api.core import WaveVerify as JWaveVerify
from waveverify_tpu.config import (
    DetectorConfig,
    GeneratorConfig,
    LocatorConfig,
    TrainConfig,
)
from waveverify_tpu.convert import save_weights_npz
from waveverify_torch import WatermarkID, WaveVerify
from waveverify_torch.api.audio_io import load_audio, save_audio

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)
SMALL = dict(dimension=32, channels_enc=8, kernel_size=5, last_kernel_size=5,
             residual_kernel_size=5, dilation_base=1, skip="identity",
             causal=True, encoder_l2norm=True, bias=True,
             spec_compression="log", zero_init=False)
T = 32000
GEOMETRY = dict(long_threshold=16000, chunk_samples=6400, chunk_context=6400)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = TrainConfig(
        generator=GeneratorConfig(channels_dec=12, n_residual_enc=1,
                                  n_residual_dec=1, **SMALL),
        detector=DetectorConfig(n_residual_enc=1, output_dim=8, **SMALL),
        locator=LocatorConfig(n_residual_enc=1, output_dim=8, **SMALL),
    )
    jw = JWaveVerify(config=cfg)
    path = save_weights_npz(jw.params, tmp_path_factory.mktemp("w") / "small.npz",
                            dtype=np.float32, config=cfg)
    tw = WaveVerify(path, device="cpu")
    for w in (jw, tw):
        for k, v in GEOMETRY.items():
            setattr(w, k, v)
    rng = np.random.RandomState(3)
    audio = (rng.randn(T) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (1, 16)).astype(np.float32)
    return jw, tw, audio, bits


def test_chunk_geometry_matches_jax(pair):
    jw, tw, audio, _ = pair
    got = [(x.shape, keep, s, n) for x, keep, s, n in tw._iter_chunks(audio)]
    want = [(tuple(x.shape), keep, s, n) for x, keep, s, n in jw._iter_chunks(audio)]
    assert got == want and len(got) == 4
    assert sum(n for *_, n in got) == T
    assert all(s % tw.hop == 0 for _, _, s, _ in got)


def test_embed_long(pair):
    jw, tw, audio, bits = pair
    chunked = tw._embed_long(audio, bits)
    x, t = tw._pad_bucket(audio)
    np.testing.assert_allclose(chunked, tw._embed(x, bits)[0, :t], **TOL)
    np.testing.assert_allclose(chunked, jw._embed_long(audio, jnp.asarray(bits)),
                               **TOL)


def test_detect_long(pair):
    jw, tw, audio, _ = pair
    probs, conf = tw._detect_long(audio)
    x, t = tw._pad_bucket(audio)
    mono = tw._detect_probs(x)[0, :t].mean(dim=0).numpy()
    np.testing.assert_allclose(probs, mono, **TOL)
    probs_j, conf_j = jw._detect_long(audio)
    np.testing.assert_allclose(probs, probs_j, **TOL)
    assert abs(conf - conf_j) <= TOL["atol"]


def test_locate_long(pair):
    jw, tw, audio, _ = pair
    mask = tw._locate_long(audio)
    x, t = tw._pad_bucket(audio)
    np.testing.assert_allclose(mask, tw._locate(x)[0, :t], **TOL)
    np.testing.assert_allclose(mask, jw._locate_long(audio), **TOL)


def test_public_entry_points_take_the_chunked_path(pair, tmp_path):
    _, tw, audio, bits = pair

    assert audio.shape[-1] > tw.long_threshold
    probs, conf = tw._detect_long(audio)
    wm_id, conf_pub = tw.detect_array(audio)
    assert conf_pub == conf
    assert wm_id.to_bits() == "".join(str(int(p > 0.5)) for p in probs)
    np.testing.assert_array_equal(tw.locate_array(audio), tw._locate_long(audio))
    save_audio(audio, tmp_path / "long.wav")
    wm = WatermarkID.custom("".join(str(int(b)) for b in bits[0]))
    out, sr, _ = tw.embed(tmp_path / "long.wav", wm)
    clean, _ = load_audio(tmp_path / "long.wav")
    assert sr == 16000 and out.shape == (T,)
    np.testing.assert_array_equal(out, tw._embed_long(clean, bits))
