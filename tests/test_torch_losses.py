"""The port's STFT helpers, mel filterbank and losses against the JAX
package's, on the same numpy inputs (f32 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu import losses as jl
from waveverify_tpu.ops import dsp as jdsp
from waveverify_torch import losses as tl
from waveverify_torch.ops import dsp as tdsp

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
B, T, W = 3, 2000, 16


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours.detach() if isinstance(ours, torch.Tensor)
                                          else ours),
                               np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (512, 128), (2048, 512), (32, 8)])
def test_stft_matches_jax(n_fft, hop):
    x = _rand(B, T, scale=0.3)
    re, im = tdsp.stft(torch.from_numpy(x), n_fft, hop)
    jre, jim = jdsp.stft(jnp.asarray(x), n_fft, hop)
    # the DFT sums n_fft products of O(1) terms
    _close(re, jre, atol=1e-5 * n_fft ** 0.5)
    _close(im, jim, atol=1e-5 * n_fft ** 0.5)


@pytest.mark.parametrize("window,hop", [(2048, 512), (1024, 256), (512, 128), (256, 64)])
def test_stft_match_stride_matches_jax(window, hop):
    x = _rand(B, T, scale=0.3, seed=1)
    re, im = tdsp.stft_match_stride(torch.from_numpy(x), window, hop)
    jre, jim = jdsp.stft_match_stride(jnp.asarray(x), window, hop)
    assert re.shape == jre.shape == (B, -(-T // hop), window // 2 + 1)
    _close(re, jre, atol=1e-5 * window ** 0.5)
    _close(im, jim, atol=1e-5 * window ** 0.5)


def test_frame_signal_matches_jax():
    x = _rand(2, 100)
    np.testing.assert_array_equal(
        tdsp.frame_signal(torch.from_numpy(x), 16, 5).numpy(),
        np.asarray(jdsp.frame_signal(jnp.asarray(x), 16, 5)))


@pytest.mark.parametrize("n_fft,n_mels", [(32, 5), (256, 40), (2048, 320),
                                          (1024, 160)])
def test_mel_filterbank_equals_jax(n_fft, n_mels):
    np.testing.assert_array_equal(tl.mel_filterbank(16000, n_fft, n_mels),
                                  jl.mel_filterbank(16000, n_fft, n_mels))


def _pair(seed):
    x = _rand(B, T, seed=seed, scale=0.2)
    y = x + _rand(B, T, seed=seed + 1, scale=0.01)
    return x, y


ELEMENTWISE = ["l1_loss", "l2_loss"]


@pytest.mark.parametrize("name", ELEMENTWISE)
def test_elementwise_losses(name):
    x, y = _pair(0)
    _close(getattr(tl, name)(torch.from_numpy(x), torch.from_numpy(y)),
           getattr(jl, name)(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("reduce", [True, False])
def test_bce_with_logits(reduce):
    z = _rand(B, 50, 4, seed=2, scale=4.0)
    tgt = (np.random.RandomState(3).rand(B, 50, 4) > 0.5).astype(np.float32)
    _close(tl.bce_with_logits(torch.from_numpy(z), torch.from_numpy(tgt), reduce),
           jl.bce_with_logits(jnp.asarray(z), jnp.asarray(tgt), reduce))


@pytest.mark.parametrize("zero_mean,clip_min", [(True, None), (False, None),
                                                (True, -5.0)])
def test_sisdr_loss(zero_mean, clip_min):
    x, y = _pair(4)
    _close(tl.sisdr_loss(torch.from_numpy(x), torch.from_numpy(y), zero_mean,
                         clip_min),
           jl.sisdr_loss(jnp.asarray(x), jnp.asarray(y), zero_mean, clip_min))


@pytest.mark.parametrize("windows,mag_weight", [((2048, 512), 1.0), ((256,), 0.0),
                                                ((512,), 2.0)])
def test_multi_scale_stft_loss(windows, mag_weight):
    x, y = _pair(5)
    _close(tl.multi_scale_stft_loss(torch.from_numpy(x), torch.from_numpy(y),
                                    window_lengths=windows, mag_weight=mag_weight),
           jl.multi_scale_stft_loss(jnp.asarray(x), jnp.asarray(y),
                                    window_lengths=windows, mag_weight=mag_weight))


@pytest.mark.parametrize("n_mels,windows,mag_weight,pow", [
    ((5, 10, 20, 40, 80, 160, 320), (32, 64, 128, 256, 512, 1024, 2048), 0.0, 1.0),
    ((5, 10), (128, 256), 1.0, 2.0),
])
def test_mel_spectrogram_loss(n_mels, windows, mag_weight, pow):
    x, y = _pair(6)
    kw = dict(n_mels=n_mels, window_lengths=windows, mag_weight=mag_weight, pow=pow)
    _close(tl.mel_spectrogram_loss(torch.from_numpy(x), torch.from_numpy(y), **kw),
           jl.mel_spectrogram_loss(jnp.asarray(x), jnp.asarray(y), **kw))


def _logits_mask_msg(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, 200, W) * 2).astype(np.float32)
    mask = (rng.rand(B, 200) > 0.3).astype(np.float32)
    mask[-1] = 0.0  # a sample with no watermarked frame
    msg = rng.randint(0, 2, (B, W)).astype(np.float32)
    bit_mask = (np.arange(W) < 5).astype(np.float32)
    return logits, mask, msg, bit_mask


@pytest.mark.parametrize("with_bits", [False, True])
def test_decoding_loss(with_bits):
    logits, mask, msg, bit_mask = _logits_mask_msg(7)
    bm = bit_mask if with_bits else None
    _close(tl.decoding_loss(torch.from_numpy(logits), torch.from_numpy(mask),
                            torch.from_numpy(msg),
                            None if bm is None else torch.from_numpy(bm)),
           jl.decoding_loss(jnp.asarray(logits), jnp.asarray(mask),
                            jnp.asarray(msg), None if bm is None else jnp.asarray(bm)))


@pytest.mark.parametrize("with_mask,with_bits", [(False, False), (False, True),
                                                 (True, False), (True, True)])
def test_decoding_loss_bits(with_mask, with_bits):
    logits, mask, msg, bit_mask = _logits_mask_msg(8)
    m = mask if with_mask else None
    bm = bit_mask if with_bits else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    _close(tl.decoding_loss_bits(t(logits), t(m), t(msg), t(bm)),
           jl.decoding_loss_bits(j(logits), j(m), j(msg), j(bm)))


@pytest.mark.parametrize("ndim", [2, 3])
def test_localization_loss(ndim):
    logits, mask, _, _ = _logits_mask_msg(9)
    loc = logits[..., 0] if ndim == 2 else logits[..., :1]
    _close(tl.localization_loss(torch.from_numpy(loc), torch.from_numpy(mask)),
           jl.localization_loss(jnp.asarray(loc), jnp.asarray(mask)))


def _toy_disc(weights):
    """A two-map 'discriminator' of one conv, in both packages."""
    w1, w2 = weights

    def jax_apply(x):
        h = jnp.stack([jnp.tanh(jnp.convolve(r, w1, mode="same")) for r in x])
        return [[h, h * w2], [h[:, ::2], (h[:, ::2] ** 2) * w2]]

    def torch_apply(x):
        k = torch.from_numpy(w1[::-1].copy())[None, None]
        pad = (len(w1) - 1) // 2
        h = torch.tanh(torch.nn.functional.conv1d(
            x[:, None], k, padding=(pad,))[:, 0, :x.shape[1]])
        return [[h, h * float(w2)], [h[:, ::2], (h[:, ::2] ** 2) * float(w2)]]

    return jax_apply, torch_apply


def test_generator_loss_and_gp_on_a_toy_critic():
    w1 = _rand(5, seed=10, scale=0.5)
    ja, ta = _toy_disc((w1, 1.7))
    x, y = _pair(11)
    x, y = x[:, :200], y[:, :200]
    g, f = tl.generator_loss(ta, torch.from_numpy(x), torch.from_numpy(y))
    jg, jf = jl.generator_loss(ja, jnp.asarray(x), jnp.asarray(y))
    _close(g, jg)
    _close(f, jf)
    key = jax.random.PRNGKey(3)
    alpha = np.array(jax.random.uniform(key, (B, 1)))[:, 0].copy()
    d = tl.discriminator_loss(ta, torch.from_numpy(x), torch.from_numpy(y),
                              alpha=torch.from_numpy(alpha))
    jd = jl.discriminator_loss(ja, jnp.asarray(x), jnp.asarray(y), key=key)
    _close(d, jd, rtol=1e-5)
