"""WavMark in the port (``waveverify_torch.models.wavmark``, ``ops/dsp.py``'s
``istft``, ``WaveVerify`` with a ``WavMarkConfig``) against the plain
reference (``tests/wavmark_reference.py``, plain torch, nothing of the
port) on seeded weights, at a small size on the CPU: 2 blocks, n_fft 64,
hop 16, 0.1 s segments, growth 32 kept.

Tolerances (readings on this CPU over the seeds and lengths below; the
control is the reference with every product rounded to TF32, which fails
each of them):

- ``WM_TOL``, a watermarked sample's largest gap over the reference
  residual's peak: 5e-5. The port's spectra are rDFT matmuls in float64
  against ``torch.stft``'s float32 FFT, and its residual comes back through
  ``+ audio``: 4.3e-6 to 6.9e-6. TF32 reads 4.7e-4 to 6.0e-4.
- ``MSG_TOL``, the largest gap of a decoded value or of a payload
  probability: 1e-6. The port reads 6.0e-8 to 1.2e-7; TF32 reads 8.0e-5 to
  1.2e-4.
- ``INN_TOL``, the network alone (forward, reverse, a block's reverse of its
  forward), gap over the reference output's peak: 1e-6. The port's convs
  are the reference's (the same calls): 0 against the reference, 5.2e-8 to
  1.0e-7 for a block's round trip.
- ``STFT_TOL``, the spectra at the published n_fft 1000 and hop 400 on a 1 s
  clip, gap over the peak: 5e-6. The matmul sums 1000 products in f32:
  3.2e-7 to 5.2e-7 against ``torch.stft``, 8.0e-7 to 1.05e-6 for
  ``istft(stft(x))`` and against ``torch.istft``.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import wavmark_reference as rw
from waveverify_torch import WaveVerify, spans
from waveverify_torch.api.audio_io import save_audio
from waveverify_torch.config import AudioSealConfig, WavMarkConfig
from waveverify_torch.convert import convert_wavmark
from waveverify_torch.models.wavmark import WavMarkModels, init_wavmark
from waveverify_torch.ops.dsp import istft, stft

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("pb_reference_ops",
                                               REPO / "portbench" / "reference" / "ops.py")
_ops = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ops)
F32, TF32 = _ops.Ops(), _ops.Ops(tf32=True)

WM_TOL, MSG_TOL, INN_TOL, STFT_TOL = 5e-5, 1e-6, 1e-6, 5e-6
SEEDS = (0, 1, 2)
LENGTHS = (3200, 4001)  # whole segments, and a tail
CFG = WavMarkConfig(segment=1600, n_fft=64, hop_length=16, num_layers=2)
REF = {**rw.PUBLISHED, "segment": 1600, "n_fft": 64, "hop": 16, "num_layers": 2}
PATTERN = list(CFG.pattern)


def state_dict(seed):
    return rw.make_state_dict(seed, REF)


def save(tmp_path, sd, name="wavmark.pth"):
    torch.save(sd, tmp_path / name)
    return tmp_path / name


def port_models(seed):
    models = WavMarkModels(CFG)
    flat = convert_wavmark({k: v.numpy() for k, v in state_dict(seed).items()}, models)
    models.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    return models.eval()


def clips(seed, length, b=2):
    g = np.random.default_rng(seed + 100)
    t = np.arange(length) / 16000.0
    audio = 0.3 * np.sin(2 * np.pi * g.uniform(100, 300, (b, 1)) * t) + 0.05 * g.standard_normal(
        (b, length))
    return audio.astype(np.float32), g.integers(0, 2, (b, 16)).astype(np.float32)


def all_bits(payload):
    return torch.cat([torch.tensor([PATTERN] * len(payload), dtype=torch.float32),
                      torch.as_tensor(payload)], dim=1)


def gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def rel_gap(a, ref):
    return gap(a, ref) / float(np.max(np.abs(np.asarray(ref))))


def spectra(seed, n=3):
    audio, _ = clips(seed, 1600 * n, b=1)
    return rw.spectrum(REF, torch.from_numpy(audio).reshape(n, 1600))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rev", [False, True])
def test_inn_against_the_reference(seed, rev):
    models = port_models(seed)
    x1, x2 = spectra(seed), spectra(seed + 10)
    with torch.no_grad():
        got = models.hinet(x1, x2, rev=rev)
    want = rw.hinet(F32, state_dict(seed), REF, x1, x2, rev=rev)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 2, 1600 // 16 + 1, 33)
        assert rel_gap(g, w) < INN_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_a_block_reverse_undoes_its_forward(seed):
    block = port_models(seed).hinet.inv_blocks[1]
    x1, x2 = spectra(seed), spectra(seed + 10)
    with torch.no_grad():
        y1, y2 = block(x1, x2)
        z1, z2 = block.reverse(y1, y2)
    assert rel_gap(y1, x1) > 1e-3  # the block moved its input
    assert rel_gap(z1, x1) < INN_TOL and rel_gap(z2, x2) < INN_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_stft_and_istft_against_torch(seed):
    """The port's ``stft`` and ``istft`` at WavMark's n_fft 1000, hop 400 on
    a 1 s clip: against ``torch.stft`` / ``torch.istft``, and the round
    trip returns the clip."""
    x = torch.from_numpy(clips(seed, 16000)[0])
    window = torch.hann_window(1000)
    want = torch.stft(x, 1000, 400, window=window, center=True, pad_mode="reflect",
                      return_complex=True).transpose(1, 2)
    re, im = stft(x, 1000, 400)
    assert re.shape == (2, 41, 501)
    assert rel_gap(torch.stack((re, im)), torch.stack((want.real, want.imag))) < STFT_TOL
    back = istft(torch.cat((re, im), dim=-1), 1000, 400, 16000)
    assert back.shape == x.shape and rel_gap(back, x) < STFT_TOL
    spec = torch.cat((want.real, want.imag), dim=-1)
    ref = torch.istft(want.transpose(1, 2), 1000, 400, window=window, center=True,
                      length=16000)
    assert rel_gap(istft(spec, 1000, 400, 16000), ref) < STFT_TOL


def test_istft_refuses_a_window_that_does_not_overlap():
    with pytest.raises(ValueError, match="cannot be inverted"):
        istft(torch.zeros(1, 3, 2 * 33), 64, 80, 160)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_waveverify_serves_wavmark(seed, length, tmp_path):
    """``embed_batch`` / ``detect_batch`` under a ``WavMarkConfig``, weights
    from a state dict in the published layout, against the reference."""
    sd = state_dict(seed)
    wv = WaveVerify(save(tmp_path, sd), config=CFG, device="cpu")
    assert wv.models.whole_input and wv.sample_rate == 16000 and wv.hop == 16
    audio, payload = clips(seed, length)
    wm = wv.embed_batch(audio, payload)
    want = rw.embed(F32, sd, REF, torch.from_numpy(audio), all_bits(payload))
    res = want.numpy() - audio
    assert gap(wm, want) / np.abs(res).max() < WM_TOL
    v = rw.decode(F32, sd, REF, torch.from_numpy(wm))
    with torch.no_grad():
        got_v = wv.models.apply_detector(torch.from_numpy(wm))
    assert got_v.shape == (2, length // 1600, 32) and gap(got_v, v) < MSG_TOL
    probs_ref, conf_ref = rw.decide(v, PATTERN)
    bits, conf = wv.detect_batch(wm)
    sure = np.abs(probs_ref.numpy() - 0.5) > 1e-3
    assert np.array_equal(bits[sure], (probs_ref.numpy() > 0.5).astype(int)[sure])
    assert gap(conf, conf_ref) < 1e-6
    probs, _ = wv._detect_on(wv.models, wv.device, wm, length)
    assert gap(probs, probs_ref) < MSG_TOL


def test_embed_detect_verify_a_file(tmp_path):
    sd = state_dict(1)
    wv = WaveVerify(save(tmp_path, sd), config=CFG, device="cpu")
    audio, _ = clips(1, 4001, b=1)
    path = tmp_path / "clip.wav"
    save_audio(audio[0], path, 16000)
    out, sr, ident = wv.embed(path, 0x1234, output_path=tmp_path / "marked.wav")
    assert sr == 16000 and out.shape == (4001,)
    v = rw.decode(F32, sd, REF, torch.from_numpy(out[None]))
    probs_ref, conf_ref = rw.decide(v, PATTERN)
    found, conf = wv.detect_array(out)
    assert [int(b) for b in found.to_bits()] == (probs_ref[0].numpy() > 0.5).astype(int).tolist()
    assert conf == pytest.approx(float(conf_ref[0]), abs=1e-6)
    assert wv.verify(tmp_path / "marked.wav", found) is True
    assert wv.detect(tmp_path / "marked.wav")[0].to_bits() == found.to_bits()


def test_the_tail_is_unmarked_and_ignored(tmp_path):
    """A tail under a segment comes back as it went in, and detection reads
    whole segments only; a clip shorter than a segment is not marked and
    reads all zeros."""
    wv = WaveVerify(save(tmp_path, state_dict(0)), config=CFG, device="cpu")
    audio, payload = clips(0, 4001)
    wm = wv.embed_batch(audio, payload)
    assert np.array_equal(wm[:, 3200:], audio[:, 3200:])
    assert gap(wm[:, :3200], audio[:, :3200]) > 1e-3
    changed = wm.copy()
    changed[:, 3200:] = 0.9
    for a, b in zip(wv.detect_batch(wm), wv.detect_batch(changed)):
        assert np.array_equal(a, b)
    short, _ = clips(0, 1599)
    assert np.array_equal(wv.embed_batch(short, payload), short)
    bits, conf = wv.detect_batch(short)
    assert not bits.any() and not conf.any()


def test_locate_is_refused(tmp_path):
    wv = WaveVerify(config=CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="no locator"):
        wv.locate_array(clips(0, 3200, b=1)[0][0])


def _layouts(sd):
    return {"plain": sd, "module": {"module." + k: v for k, v in sd.items()},
            "wrapped": {"model": sd, "step": 59000}}


@pytest.mark.parametrize("layout", ["plain", "module", "wrapped"])
def test_the_published_layout_loads_and_round_trips(layout, tmp_path):
    """A state dict in the published ``Model``'s keys loads (prefixed or
    wrapped as checkpoints come), and the port's parameters read back as the
    same state dict under the published names."""
    sd = state_dict(2)
    wv = WaveVerify(save(tmp_path, _layouts(sd)[layout]), config=CFG, device="cpu")
    back = {}
    for name, value in wv.models.state_dict().items():
        stem, _, leaf = name.rpartition(".")
        back[f"{stem}.{ {'v': 'weight', 'b': 'bias'}.get(leaf, leaf) }"] = value
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("fault,error", [("missing", KeyError), ("extra", KeyError),
                                         ("misshapen", ValueError)])
def test_bad_state_dicts_raise(fault, error, tmp_path):
    sd = dict(state_dict(0))
    if fault == "missing":
        del sd["hinet.inv_blocks.1.f.conv5.bias"]
    elif fault == "extra":
        sd["hinet.inv_blocks.2.f.conv1.weight"] = torch.zeros(32, 2, 3, 3)
    else:
        sd["watermark_fc.weight"] = torch.zeros(1600, 16)
    with pytest.raises(error):
        WaveVerify(save(tmp_path, sd), config=CFG, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_fails_a_tolerance(seed):
    """The control: the reference with its products in TF32 fails the
    watermarked audio's tolerance and the decoded values'."""
    sd = state_dict(seed)
    audio, payload = clips(seed, 3200)
    a, bits = torch.from_numpy(audio), all_bits(payload)
    want = rw.embed(F32, sd, REF, a, bits)
    low = rw.embed(TF32, sd, REF, a, bits)
    assert gap(low, want) / float((want - a).abs().max()) > WM_TOL
    assert gap(rw.decode(TF32, sd, REF, want), rw.decode(F32, sd, REF, want)) > MSG_TOL


def test_published_parameter_count():
    """The released model: 24 dense subnets of 60,070 parameters and the two
    linears, 2,481,712 in all; the reference's layout holds the same."""
    models = WavMarkModels(WavMarkConfig())
    n = sum(p.numel() for p in models.parameters())
    subnet = sum(p.numel() for p in models.hinet.inv_blocks[0].r.parameters())
    assert (subnet, n) == (60070, 24 * 60070 + 528000 + 512032) == (60070, 2481712)
    assert sum(math.prod(s) for _, s, *_ in rw.state_spec(rw.PUBLISHED)) == n
    widths = [getattr(models.hinet.inv_blocks[0].f, f"conv{k}").v.shape[1] for k in range(1, 6)]
    assert widths == [2, 34, 66, 98, 130]


def test_random_init_is_the_identity_network():
    """No checkpoint: PyTorch's default draws from the seed, each ``conv5``
    zero as HiNet starts it, so embedding returns the audio (give or take
    the STFT's round trip)."""
    wv = WaveVerify(config=CFG, seed=5, device="cpu")
    again = WaveVerify(config=CFG, seed=5, device="cpu").models.state_dict()
    sd = wv.models.state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["hinet.inv_blocks.0.r.conv1.v"],
                           WaveVerify(config=CFG, seed=6, device="cpu").models.state_dict()[
                               "hinet.inv_blocks.0.r.conv1.v"])
    conv1 = sd["hinet.inv_blocks.0.r.conv1.v"]
    assert 0.5 / math.sqrt(18) < conv1.abs().max() <= 1 / math.sqrt(18)
    assert not sd["hinet.inv_blocks.1.y.conv5.v"].any()
    audio, payload = clips(0, 3200)
    assert gap(wv.embed_batch(audio, payload), audio) < 1e-6


def test_init_wavmark_draws_every_parameter():
    models = WavMarkModels(CFG)
    for p in models.parameters():
        torch.nn.init.constant_(p, float("nan"))
    init_wavmark(models, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in models.parameters())


def test_bf16_and_bad_patterns_are_refused():
    with pytest.raises(NotImplementedError, match="float32"):
        WaveVerify(config=CFG, serve_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="0 or 1"):
        WavMarkModels(WavMarkConfig(pattern=(1, 2)))


def test_each_model_has_its_loader():
    """The config's type picks the loader; WaveVerify's own is the default."""
    assert set(WaveVerify._LOADERS) == {AudioSealConfig, WavMarkConfig}
    assert type(WaveVerify(config=CFG, device="cpu").models) is WavMarkModels


def test_wavmark_spans():
    """Under a profiler an embed+detect call records 3 ``wavmark.stft`` and
    2 ``wavmark.istft`` spans, 2 ``wavmark.inn`` (one a pass) and 2 x
    ``num_layers`` ``inn.block`` inside them; at the published 8 blocks that
    is 16 blocks a call."""
    for cfg in (CFG, WavMarkConfig(segment=1600, n_fft=64, hop_length=16)):
        wv = WaveVerify(config=cfg, seed=0, device="cpu")
        audio, payload = clips(0, 3200)
        spans.drain()
        with profile(activities=[ProfilerActivity.CPU]):
            wv.detect_batch(wv.embed_batch(audio, payload))
        records, dropped = spans.drain()
        by_id = {r["id"]: r for r in records}
        count = {name: sum(r["name"] == name for r in records)
                 for name in ("wavmark.stft", "wavmark.istft", "wavmark.inn", "inn.block")}
        assert dropped == 0
        assert count == {"wavmark.stft": 3, "wavmark.istft": 2, "wavmark.inn": 2,
                         "inn.block": 2 * cfg.num_layers}
        inn = [r for r in records if r["name"] == "wavmark.inn"]
        assert [by_id[r["parent"]]["name"] for r in inn] == ["api.generator", "api.detector"]
        assert {by_id[r["parent"]]["name"] for r in records if r["name"] == "inn.block"} == {
            "wavmark.inn"}
    wv.detect_batch(wv.embed_batch(audio, payload))
    assert spans.drain() == ([], 0)


def test_the_reference_has_one_text():
    """``tests/wavmark_reference.py`` is ``portbench/reference/wavmark.py``."""
    here = (REPO / "tests" / "wavmark_reference.py").read_bytes()
    assert here == (REPO / "portbench" / "reference" / "wavmark.py").read_bytes()


# -- on the card -----------------------------------------------------------------------


@pytest.mark.cuda
def test_waveverify_serves_wavmark_on_the_card(tmp_path):
    """``embed_batch`` / ``detect_batch`` on the card against the reference
    on the card, with the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    sd = state_dict(1)
    wv = WaveVerify(save(tmp_path, sd), config=CFG, device="cuda")
    audio, payload = clips(1, 4001)
    wm = wv.embed_batch(audio, payload)
    p = {k: v.to(dev) for k, v in sd.items()}
    want = rw.embed(F32, p, REF, torch.from_numpy(audio).to(dev), all_bits(payload).to(dev))
    res = want.cpu().numpy() - audio
    assert gap(wm, want.cpu()) / np.abs(res).max() < WM_TOL
    v = rw.decode(F32, p, REF, torch.from_numpy(wm).to(dev))
    with torch.no_grad():
        got = wv.models.apply_detector(torch.from_numpy(wm).to(dev))
    assert gap(got.cpu(), v.cpu()) < MSG_TOL
