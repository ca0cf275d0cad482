"""The port's STDCT / MDCT / PQMF and audio_processor against the JAX
package's, f32 on the CPU, within 1e-5: every transform and inverse at the
JAX tests' sizes and more, the prototype filter, and every length mode of
audio and mask; plus the JAX tests' reconstruction invariants and input
checks, run on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu.ops import audio_processor as japops
from waveverify_tpu.ops import transforms as jtr
from waveverify_torch.ops import MDCT, PQMF, STDCT, design_prototype_filter
from waveverify_torch.ops import audio_processor as aps

torch.set_num_threads(2)

ATOL = 1e-5


def _close(port, ref):
    assert tuple(port.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def _x(b, t, seed):
    return np.random.RandomState(seed).randn(b, t).astype(np.float32)


# (N, hop, window): the JAX tests' Hann 64/32, odd hops (the clipped last
# frame), odd N (output padding), hop = N, no window
STDCT_CASES = [(64, 32, "hann"), (64, 33, "hann"), (63, 32, "hann"),
               (16, 16, None), (32, 8, None)]


@pytest.mark.parametrize("n,hop,win", STDCT_CASES)
def test_stdct_and_inverse_match_jax(n, hop, win):
    window = np.hanning(n).astype(np.float32) if win else None
    x = _x(2, 1024, 0)
    tj, tp = jtr.STDCT(n, hop, window), STDCT(n, hop, window)
    spec_j = tj(jnp.asarray(x))
    spec_p = tp(torch.from_numpy(x))
    _close(spec_p, spec_j)
    _close(tp.inverse(torch.from_numpy(np.array(spec_j))), tj.inverse(spec_j))
    assert tp.nola_satisfied() == tj.nola_satisfied()


@pytest.mark.parametrize("n,normalize", [(32, True), (16, True), (32, False)])
def test_mdct_and_inverse_match_jax(n, normalize):
    x = _x(2, n * 16, 1)
    tj, tp = jtr.MDCT(n, normalize), MDCT(n, normalize)
    spec_j = tj(jnp.asarray(x))
    _close(tp(torch.from_numpy(x)), spec_j)
    _close(tp.inverse(torch.from_numpy(np.array(spec_j))), tj.inverse(spec_j))


@pytest.mark.parametrize("subbands,taps,t", [(4, 62, 4096), (2, 32, 2048),
                                             (8, 62, 4000)])
def test_pqmf_analysis_synthesis_match_jax(subbands, taps, t):
    x = _x(2, t, 2)
    qj, qp = jtr.PQMF(subbands, taps), PQMF(subbands, taps)
    sub_j = qj.analysis(jnp.asarray(x))
    _close(qp.analysis(torch.from_numpy(x)), sub_j)
    _close(qp(torch.from_numpy(x)), qj(jnp.asarray(x)))
    _close(qp.synthesis(torch.from_numpy(np.array(sub_j))), qj.synthesis(sub_j))


def test_prototype_filter_matches_jax():
    for kw in ({}, {"taps": 32, "cutoff_ratio": 0.2, "beta": 7.0}):
        h = design_prototype_filter(**kw)
        np.testing.assert_array_equal(h, jtr.design_prototype_filter(**kw))
    h = design_prototype_filter()
    assert h.shape == (63,)
    np.testing.assert_allclose(h, h[::-1], atol=1e-12)
    with pytest.raises(ValueError, match="even"):
        design_prototype_filter(taps=61)
    with pytest.raises(ValueError, match="cutoff_ratio"):
        design_prototype_filter(cutoff_ratio=1.5)


def test_stdct_roundtrip():
    x = _x(2, 1024, 3)
    t = STDCT(N=64, hop_size=32, window=np.hanning(64).astype(np.float32))
    assert t.nola_satisfied()
    y = t.inverse(t(torch.from_numpy(x))).numpy()
    n = min(y.shape[1], x.shape[1])
    np.testing.assert_allclose(y[:, 64:n - 64], x[:, 64:n - 64], atol=1e-3)


def test_mdct_tdac_roundtrip():
    n = 32
    x = _x(2, n * 16, 4)
    t = MDCT(N=n)
    y = t.inverse(t(torch.from_numpy(x))).numpy()
    assert y.shape == x.shape
    np.testing.assert_allclose(y[:, n:-n], x[:, n:-n], atol=1e-3)


def test_pqmf_near_perfect_reconstruction():
    x = _x(2, 4096, 5)
    pq = PQMF(subbands=4)
    sub = pq.analysis(torch.from_numpy(x))
    assert sub.shape == (2, 1024, 4)
    y = pq.synthesis(sub).numpy()
    assert y.shape == x.shape
    c = np.correlate(y[0], x[0], mode="full")
    delay = int(np.argmax(c)) - (len(x[0]) - 1)
    assert 0 <= delay <= pq.taps
    ys = y[:, delay:]
    xs = x[:, :ys.shape[1]]
    m = ys.shape[1] - 128
    snr = 10 * np.log10(np.sum(xs[:, 64:m] ** 2)
                        / (np.sum((ys[:, 64:m] - xs[:, 64:m]) ** 2) + 1e-12))
    assert snr > 30.0, snr


LENGTHS = [(1000, 1500), (1500, 1000), (777, 1024), (320, 321), (100, 33)]


@pytest.mark.parametrize("mode", ["pad_truncate", "stretch", "nearest"])
@pytest.mark.parametrize("cur,target", LENGTHS)
def test_adjust_audio_length_matches_jax(mode, cur, target):
    x = np.random.RandomState(6).randn(2, 3, cur).astype(np.float32)
    out = aps.adjust_audio_length(torch.from_numpy(x), target, mode)
    _close(out, japops.adjust_audio_length(jnp.asarray(x), target, mode))


@pytest.mark.parametrize("mode", ["pad_truncate", "stretch", "nearest-exact"])
@pytest.mark.parametrize("cur,target", LENGTHS)
def test_adjust_mask_length_matches_jax(mode, cur, target):
    m = (np.random.RandomState(7).rand(2, cur) > 0.5).astype(np.float32)
    out = aps.adjust_mask_length(torch.from_numpy(m), target, mode)
    ref = np.asarray(japops.adjust_mask_length(jnp.asarray(m), target, mode))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert set(np.unique(out.numpy())) <= {0.0, 1.0}


def test_length_modes_match_torch_interpolate():
    """stretch, nearest and nearest-exact are F.interpolate's modes."""
    import torch.nn.functional as F

    x = torch.from_numpy(np.random.RandomState(8).randn(1, 1, 777).astype(np.float32))
    for mode, ours in (("linear", "stretch"), ("nearest", "nearest")):
        ref = F.interpolate(x, size=1024, mode=mode,
                            **({"align_corners": False} if mode == "linear" else {}))
        torch.testing.assert_close(aps.adjust_audio_length(x, 1024, ours), ref,
                                   atol=5e-5, rtol=0)
    m = (x > 0).float()
    torch.testing.assert_close(aps.adjust_mask_length(m, 333, "nearest-exact"),
                               F.interpolate(m, size=333, mode="nearest-exact"),
                               atol=0, rtol=0)


def test_length_validation_and_identity():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="positive integer"):
        aps.adjust_audio_length(x, 0)
    with pytest.raises(ValueError, match="Unknown mode"):
        aps.adjust_audio_length(x, 20, "bogus")
    with pytest.raises(ValueError, match="Unknown mode"):
        aps.adjust_mask_length(x, 20, "nearest")  # an audio-only mode
    assert aps.AudioProcessor.adjust_audio_length is aps.adjust_audio_length
    assert aps.AudioProcessor.adjust_mask_length is aps.adjust_mask_length
    y = torch.ones(3, 50)
    assert aps.adjust_audio_length(y, 50) is y
    assert aps.adjust_mask_length(y, 50) is y
