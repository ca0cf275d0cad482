"""The port's sweep effects, DSP, metrics and clip sources against the JAX
package's, on the same numpy inputs, f32 on the CPU.

Tolerances: filtered and resampled audio within 2e-6 absolute (inputs of
magnitude <= 0.5; both sides sum the same f32 products in another order,
measured ~1e-7); kernels built in numpy are equal; metrics whose result is
a count (BER, MIoU) are equal; SI-SNR within 1e-4 dB; STOI within 1e-9 (the
same numpy code); clips from the same ``RandomState`` are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu import metrics as jmetrics
from waveverify_tpu.effects import effects as jeffects
from waveverify_tpu.ops import dsp as jdsp
from waveverify_tpu.train import data as jdata
from waveverify_torch import metrics
from waveverify_torch.effects import effects
from waveverify_torch.ops import dsp
from waveverify_torch.train import data

torch.set_num_threads(2)

ATOL = 2e-6
SR = 16000


def _audio(b=3, t=4000, seed=0):
    return (np.random.RandomState(seed).randn(b, t) * 0.1).astype(np.float32)


def _mask(b=3, t=4000, seed=1):
    rng = np.random.RandomState(seed)
    m = np.ones((b, t), np.float32)
    for i, s in enumerate(rng.randint(0, t - t // 5, b)):
        m[i, s:s + t // 5] = 0.0
    return m


DETERMINISTIC = [
    ("identity", {}),
    ("highpass_filter", {"cutoff_freq": 3500}),
    ("lowpass_filter", {"cutoff_freq": 2000}),
    ("bandpass_filter", {"cutoff_freq_low": 300, "cutoff_freq_high": 4000}),
    ("speed", {"speed": 0.8}),
    ("speed", {"speed": 1.25}),
    ("resample", {"new_sample_rate": 8000}),
    ("resample", {"new_sample_rate": 32000}),
    ("time_shift", {"shift": 161}),
]


@pytest.mark.parametrize("name,params", DETERMINISTIC,
                         ids=[f"{n}{tuple(p.values())}" for n, p in DETERMINISTIC])
def test_effect_matches_jax(name, params):
    audio, mask = _audio(), _mask()
    y_j, m_j = getattr(jeffects.AudioEffects, name)(
        jnp.asarray(audio), jnp.asarray(mask), jax.random.PRNGKey(0),
        sample_rate=SR, **params)
    y_t, m_t = getattr(effects.AudioEffects, name)(
        torch.from_numpy(audio), torch.from_numpy(mask), None,
        sample_rate=SR, **params)
    assert y_t.shape == audio.shape and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


@pytest.mark.parametrize("cutoff", [300 / SR, 2000 / SR, 3500 / SR, 4000 / SR])
def test_fir_kernels_and_filters_match_jax(cutoff):
    hw = dsp.filter_half_width(cutoff)
    assert hw == jdsp.filter_half_width(cutoff)
    np.testing.assert_array_equal(dsp._sinc_filter(cutoff, hw),
                                  jdsp._sinc_filter(cutoff, hw))
    x = _audio(2, 3000, seed=2)
    for fn in ("lowpass_fir", "highpass_fir"):
        np.testing.assert_allclose(
            getattr(dsp, fn)(torch.from_numpy(x), cutoff).numpy(),
            np.asarray(getattr(jdsp, fn)(jnp.asarray(x), cutoff)), atol=ATOL)


def test_bandpass_at_300_hz_has_429_taps():
    assert 2 * dsp.filter_half_width(300 / SR) + 1 == 429
    x = _audio(2, 3000, seed=3)
    np.testing.assert_allclose(
        dsp.bandpass_fir(torch.from_numpy(x), 300 / SR, 4000 / SR).numpy(),
        np.asarray(jdsp.bandpass_fir(jnp.asarray(x), 300 / SR, 4000 / SR)),
        atol=ATOL)


@pytest.mark.parametrize("orig,new", [(16000, 8000), (8000, 16000),
                                      (16000, 32000), (32000, 16000),
                                      (16000, 20000), (20000, 16000)])
@pytest.mark.parametrize("t", [4000, 4001])
def test_resample_matches_jax(orig, new, t):
    k_t, p, q = dsp.resample_kernel(orig, new)
    k_j, p_j, q_j = jdsp.resample_kernel(orig, new)
    assert (p, q) == (p_j, q_j)
    np.testing.assert_array_equal(k_t, k_j)
    x = _audio(2, t, seed=4)
    y_t = dsp.resample(torch.from_numpy(x), orig, new)
    y_j = np.asarray(jdsp.resample(jnp.asarray(x), orig, new))
    assert y_t.shape[-1] == y_j.shape[-1] == -(-t * q // p)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=ATOL)


def test_linear_resize_matches_jax():
    x = _audio(2, 5000, seed=5)
    for n in (4000, 6250, 5000):
        np.testing.assert_allclose(
            effects._linear_resize(torch.from_numpy(x), n).numpy(),
            np.asarray(jeffects._linear_resize(jnp.asarray(x), n)), atol=ATOL)


def test_random_noise_statistics_and_seed():
    """The noise is another realisation than JAX's: held by its std (within
    3% at 48 000 draws) and its mean, and reproducible from a seed."""
    audio = torch.from_numpy(_audio(3, 16000, seed=6))

    def noisy(seed):
        g = torch.Generator().manual_seed(seed)
        return effects.AudioEffects.random_noise(audio, None, g, noise_std=0.001)[0]

    noise = (noisy(7) - audio).double()
    assert abs(float(noise.std()) / 0.001 - 1.0) < 0.03
    assert abs(float(noise.mean())) < 0.001 * 5 / np.sqrt(noise.numel())
    torch.testing.assert_close(noisy(7), noisy(7), atol=0, rtol=0)
    assert not torch.equal(noisy(7), noisy(8))
    j_noise = np.asarray(jeffects.AudioEffects.random_noise(
        jnp.asarray(audio.numpy()), None, jax.random.PRNGKey(0),
        noise_std=0.001)[0]) - audio.numpy()
    assert abs(float(noise.std()) / float(j_noise.std()) - 1.0) < 0.05


def test_codecs_report_their_availability():
    import shutil

    assert effects.codec_available("mp3") == (shutil.which("ffmpeg") is not None)
    assert effects.codec_available("aac") == (shutil.which("ffmpeg") is not None)
    assert effects.codec_available("encodec") is False
    if shutil.which("ffmpeg") is None:
        a = torch.from_numpy(_audio(1, 2000))
        out, _ = effects.AudioEffects.mp3_lossy_compression(a, None, None)
        assert out is a


def test_wav_helpers_round_trip(tmp_path):
    x = np.linspace(-0.9, 0.9, 1000).astype(np.float32)
    effects._write_wav(str(tmp_path / "a.wav"), x, SR)
    np.testing.assert_allclose(effects._read_wav(str(tmp_path / "a.wav")), x,
                               atol=1.0 / 16384)


def test_ber_and_miou_match_jax():
    rng = np.random.RandomState(9)
    logits = (rng.randn(4, 300, 16) * 0.5).astype(np.float32)
    bits = rng.randint(0, 2, (4, 16)).astype(np.float32)
    mask = _mask(4, 300, seed=10)
    mask[3] = 0.0  # an item with no valid step
    for m in (mask, mask[..., None], None):
        for per_sample in (True, False):
            got = metrics.ber(torch.from_numpy(logits), torch.from_numpy(bits),
                              None if m is None else torch.from_numpy(m),
                              per_sample=per_sample)
            want = jmetrics.ber(jnp.asarray(logits), jnp.asarray(bits),
                                None if m is None else jnp.asarray(m),
                                per_sample=per_sample)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pred = rng.rand(4, 300).astype(np.float32)
    pred[2] = 0.0  # empty foreground in both masks of item 3
    for per_sample in (True, False):
        got = metrics.miou(torch.from_numpy(pred), torch.from_numpy(mask),
                           per_sample=per_sample)
        want = jmetrics.miou(jnp.asarray(pred), jnp.asarray(mask),
                             per_sample=per_sample)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    probs = rng.rand(4, 16).astype(np.float32)
    np.testing.assert_allclose(
        metrics.evaluate_ber(torch.from_numpy(probs), torch.from_numpy(bits)).numpy(),
        np.asarray(jmetrics.evaluate_ber(jnp.asarray(probs), jnp.asarray(bits))),
        rtol=1e-7)


def test_sisnr_stoi_pesq_match_jax():
    rng = np.random.RandomState(11)
    t = np.arange(16000) / SR
    ref = (0.1 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
           ).astype(np.float32)[None].repeat(2, 0)
    est = (ref + 0.01 * rng.randn(*ref.shape)).astype(np.float32)
    assert abs(float(metrics.sisnr(torch.from_numpy(est), torch.from_numpy(ref)))
               - float(jmetrics.sisnr(jnp.asarray(est), jnp.asarray(ref)))) < 1e-4
    assert abs(metrics.stoi(est[0], ref[0], SR) - jmetrics.stoi(est[0], ref[0], SR)) < 1e-9
    p_t, p_j = metrics.pesq(est[0], ref[0], SR), jmetrics.pesq(est[0], ref[0], SR)
    assert (np.isnan(p_t) and np.isnan(p_j)) or abs(p_t - p_j) < 1e-6


def test_synthetic_clips_match_jax():
    a = data.SyntheticAudioDataset(0.5, SR, seed=3)
    b = jdata.SyntheticAudioDataset(0.5, SR, seed=3)
    for n in (4, 2):
        np.testing.assert_array_equal(a.batch(n), b.batch(n))


def test_folder_crops_match_jax(tmp_path):
    rng = np.random.RandomState(12)
    for i, n in enumerate((3000, 9000, 12000)):
        effects._write_wav(str(tmp_path / f"c{i}.wav"),
                           (rng.randn(n) * 0.1).astype(np.float32), SR)
    a = data.AudioFolderDataset([str(tmp_path)], 0.25, SR, seed=4)
    b = jdata.AudioFolderDataset([str(tmp_path)], 0.25, SR, seed=4, use_native=False)
    assert len(a) == len(b) == 3
    np.testing.assert_array_equal(a.batch(5), b.batch(5))
