"""The port's WaveVerify (r5, device="cpu") against the JAX WaveVerify:
batched serving, bucketed single-clip detection, and a WAV round trip.
Bits must agree wherever the JAX probability is > 1e-3 from 0.5;
probabilities and confidences to 1e-4 absolute (f32, measured ~1e-6)."""

import numpy as np
import pytest
import torch

from waveverify_tpu.api.core import WaveVerify as JWaveVerify
from waveverify_torch import WatermarkID, WaveVerify
from waveverify_torch.api.core import _next_bucket

torch.set_num_threads(2)

R5 = "weights/waveverify_demo_r5.npz"


@pytest.fixture(scope="module")
def both():
    return JWaveVerify(R5), WaveVerify(R5, device="cpu")


def _clip(t, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(t) * 0.1).astype(np.float32)


def test_embed_and_detect_batch_match_jax(both):
    jw, tw = both
    rng = np.random.RandomState(1)
    audio = (rng.randn(2, 8000) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (2, 16)).astype(np.float32)
    w_j = jw.embed_batch(audio, bits)
    w_t = tw.embed_batch(audio, bits)
    assert w_t.dtype == np.float32 and w_t.shape == (2, 8000)
    np.testing.assert_allclose(w_t, w_j, atol=1e-5)
    b_j, c_j = jw.detect_batch(w_j)
    b_t, c_t = tw.detect_batch(w_j)
    np.testing.assert_allclose(c_t, c_j, atol=1e-4)
    np.testing.assert_array_equal(b_t, b_j)


def test_detect_array_off_bucket_length(both):
    jw, tw = both
    audio = _clip(7777, 2)
    assert _next_bucket(7777) != 7777
    id_j, conf_j = jw.detect_array(audio)
    id_t, conf_t = tw.detect_array(audio)
    assert abs(conf_t - conf_j) < 1e-4
    assert id_t.to_bits() == id_j.to_bits()


def test_wav_round_trip(both, tmp_path):
    jw, tw = both
    from waveverify_torch.api.audio_io import save_audio

    src = tmp_path / "clean.wav"
    save_audio(_clip(8000, 3), src)
    wm = WatermarkID.custom("1011001110001111")
    out_t, sr, wm_t = tw.embed(src, wm, tmp_path / "wm_port.wav")
    out_j, _, _ = jw.embed(src, wm.to_bits(), tmp_path / "wm_jax.wav")
    assert sr == 16000 and wm_t == wm
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    id_t, conf_t = tw.detect(tmp_path / "wm_port.wav")
    id_j, conf_j = jw.detect(tmp_path / "wm_port.wav")
    assert id_t.to_bits() == id_j.to_bits()
    assert abs(conf_t - conf_j) < 1e-4
    assert tw.verify(tmp_path / "wm_port.wav", id_t)
    assert tw.verify(tmp_path / "wm_port.wav", id_j.to_bits())


def test_bucket_rule():
    assert _next_bucket(100) == 4800
    assert _next_bucket(4801) == 6080
    assert _next_bucket(8000) == 9920


def test_cuda_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        WaveVerify(R5)
