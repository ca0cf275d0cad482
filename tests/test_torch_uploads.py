"""The port's uploads that do not block (``waveverify_torch.ops.uploads``):
the constant cache against a fresh upload of each kind of constant, the
call sites that keep their constants in it, the bank's single row upload
against the per-branch loop it replaced (forward and backward, under
``stack`` and ``scan``), and, on the card, a training step that makes no
synchronizing call. Numpy and torch only: the card test runs where JAX is
absent."""

import warnings

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tests.torch_ranks import tiny_config
from waveverify_torch import losses
from waveverify_torch.effects.effects import EffectBank, _map_draws
from waveverify_torch.ops import dsp, transforms
from waveverify_torch.ops.uploads import DeviceConsts, device_const, upload_rows
from waveverify_torch.train.loop import step_generator
from waveverify_torch.train.watermarking import draw

torch.set_num_threads(2)

# (builder, its parameters) of every kind of constant the port keeps
CONSTANTS = {
    "rdft_basis": (dsp._rdft_basis, (256,)),
    "hann_window": (dsp._hann_window, (256,)),
    "sinc_fir": (dsp._lowpass_kernel, (500 / 16000, 8)),
    "resample_kernel": (dsp._resample_weight, (16000, 20000, 24, 0.945)),
    "mel_filterbank": (losses._mel_basis, (16000, 256, 10)),
    "transforms_bank": (transforms._frombuffer, transforms._key(transforms.PQMF().bank)),
}
OTHER = {torch.float32: torch.float64, torch.float64: torch.float32}


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().cpu().numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(CONSTANTS))
def test_constant_is_a_fresh_upload_kept(kind, dtype):
    builder, params = CONSTANTS[kind]
    cache = DeviceConsts()
    like = torch.zeros((), dtype=dtype)
    t = cache(builder, *params, like=like)
    fresh = torch.as_tensor(builder(*params), dtype=dtype, device=like.device)
    assert t.dtype == dtype and t.shape == fresh.shape and _bits(t) == _bits(fresh)
    assert not t.requires_grad
    assert cache(builder, *params, like=like) is t
    other = cache(builder, *params, like=like.to(OTHER[dtype]))
    assert other is not t and other.dtype == OTHER[dtype]
    assert cache.stats() == {"hits": 1, "misses": 2, "entries": 2}


def test_constant_first_made_in_inference_mode_serves_autograd():
    cache = DeviceConsts()
    with torch.inference_mode():
        cache(dsp._hann_window, 64, like=torch.zeros(()))
    x = torch.randn(64, requires_grad=True)
    (x * cache(dsp._hann_window, 64, like=x)).sum().backward()
    assert torch.equal(x.grad, torch.as_tensor(dsp._hann_window(64)))


def _stft_site(x):
    return dsp.stft(x, 256, 64)[0]


def _fir_site(x):
    return dsp.bandpass_fir(x, 300 / 16000, 4000 / 16000)


def _resample_site(x):
    return dsp.resample(x, 16000, 12800)


def _mel_site(x):
    return losses.mel_spectrogram_loss(x, x.flip(-1), n_mels=(5, 10),
                                       window_lengths=(128, 256))


def _transforms_site(x):
    out = []
    for t in (transforms.STDCT(64, 32, np.hanning(64)), transforms.MDCT(32, False)):
        out.append(t.inverse(t(x)))
    pqmf = transforms.PQMF()
    return torch.stack(out + [pqmf.synthesis(pqmf(x))])


@pytest.mark.parametrize("site", [_stft_site, _fir_site, _resample_site, _mel_site,
                                  _transforms_site])
def test_call_site_keeps_its_constants(site):
    """A call site misses at most on its first call; the next ones hit and
    give the same values."""
    x = torch.randn(2, 3200, generator=torch.Generator().manual_seed(0))
    first = site(x)
    before = device_const.stats()
    again = site(x)
    after = device_const.stats()
    assert after["misses"] == before["misses"] and after["hits"] > before["hits"]
    assert torch.equal(first, again)


def test_upload_rows_on_the_cpu():
    rows = np.array([3, 0, 2], np.int64)
    t = upload_rows(rows, torch.device("cpu"))
    assert t.dtype == torch.int64 and t.tolist() == [3, 0, 2]
    assert upload_rows(np.zeros(0, np.int64), torch.device("cpu")).shape == (0,)


# -- the bank --------------------------------------------------------------------------

B, T = 16, 3200
# every branch of the train bank, some twice, out of order
TRAIN_IDX = np.array([8, 0, 3, 8, 1, 2, 5, 4, 6, 7, 8, 3, 0, 6, 1, 8], np.int32)
RANDOM_BANK = [("identity", {}), ("random_noise", {"noise_std": 0.01}),
               ("echo", {}), ("random_equalization", {}), ("pink_noise", {}),
               ("sample_suppression", {"suppression_percentage": 0.2}),
               ("lowpass_filter", {"cutoff_freq": 2000})]
RANDOM_IDX = np.array([1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 4, 5, 1, 1, 6, 3], np.int32)
BANKS = {"train": (EffectBank.default_train_bank().specs, TRAIN_IDX),
         "random": (RANDOM_BANK, RANDOM_IDX)}


def per_branch_apply(bank, audio, mask, effect_idx, fx_draws):
    """``EffectBank.apply`` as it was: each branch's rows copied to the
    device on their own, and again for a random branch's draws."""
    idx = np.asarray(torch.as_tensor(effect_idx).cpu())
    out_a, out_m = audio, mask
    for e in np.unique(idx):
        rows = np.flatnonzero(idx == e)
        if bank.dispatch == "scan" and e in bank.random_branches:
            calls = [([i], fx_draws[i]) for i in rows]
        else:
            kw = {}
            if e in bank.random_branches:
                r = torch.from_numpy(rows)
                kw = _map_draws(fx_draws[bank.random_branches.index(e)],
                                lambda t: t if t.dim() == 0 else t[r.to(t.device)])
            calls = [(rows, kw)]
        for r, kw in calls:
            r = torch.as_tensor(r).to(audio.device)
            a, m = bank._fns[e](audio[r], mask[r], None, **kw)
            out_a = out_a.index_put((r,), a)
            if m is not None:
                out_m = out_m.index_put((r,), m.to(mask.dtype))
    return out_a, out_m


def _bank_inputs(name, dispatch):
    specs, idx = BANKS[name]
    bank = EffectBank(specs, dispatch=dispatch)
    gen = torch.Generator().manual_seed(7)
    audio = torch.randn(B, T, generator=gen) * 0.1
    mask = (torch.rand(B, T, generator=gen) > 0.3).float()
    d = draw(step_generator(5, 0), B, T, bank.draw_specs(idx),
             per_sample=dispatch == "scan")
    return bank, audio, mask, idx, d.fx


@pytest.mark.parametrize("dispatch", ["stack", "scan"])
@pytest.mark.parametrize("name", list(BANKS))
def test_bank_single_upload_matches_per_branch_loop(name, dispatch):
    """Bit for bit, forward and backward, under ``checkpoint`` as remat
    runs the bank (its recompute uploads the rows again)."""
    bank, audio, mask, idx, fx = _bank_inputs(name, dispatch)
    weight = torch.randn(B, T, generator=torch.Generator().manual_seed(9))
    results = []
    for apply in (bank.apply, lambda *a: per_branch_apply(bank, *a)):
        x = audio.clone().requires_grad_(True)
        a, m = checkpoint(apply, x, mask, idx, fx, use_reentrant=False,
                          preserve_rng_state=False)
        (a * weight).sum().backward()
        results.append((a.detach(), m, x.grad))
    for new, old in zip(*results):
        assert _bits(new) == _bits(old)
    assert not torch.equal(results[0][0], audio)  # the attacks ran


# -- on the card -----------------------------------------------------------------------


@pytest.mark.cuda
def test_train_step_makes_no_host_wait():
    """After a warm-up step, a training step (remat on, every branch of
    the train bank, the discriminator, the STFT and mel losses) makes no
    synchronizing call under PyTorch's sync debug mode and no cache
    miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from waveverify_torch.train.state import create_train_state
    from waveverify_torch.train.step import train_step

    dev = torch.device("cuda")
    cfg = tiny_config(B, remat=True)
    bank = EffectBank.default_train_bank()
    state = create_train_state(cfg, torch.Generator().manual_seed(0), dev)

    def inputs(step):
        gen = torch.Generator().manual_seed(step)
        audio = (torch.randn(B, T, generator=gen) * 0.1).to(dev)
        msg = torch.randint(0, 2, (B, 16), generator=gen).float().to(dev)
        d = draw(step_generator(3, step), B, T, bank.draw_specs(TRAIN_IDX),
                 window_duration=cfg.window_duration).to(dev)
        return audio, msg, TRAIN_IDX, d

    train_step(state, cfg, bank, *inputs(0))
    step1 = inputs(1)
    torch.cuda.synchronize()
    before = device_const.stats()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metrics = train_step(state, cfg, bank, *step1)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert syncs == [], syncs
    assert device_const.stats()["misses"] == before["misses"]
    assert torch.isfinite(metrics["loss"]).item()
