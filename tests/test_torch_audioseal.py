"""AudioSeal in the port (``waveverify_torch.models.audioseal``,
``modules/audiocraft.py``, ``WaveVerify`` with an ``AudioSealConfig``)
against the plain reference (``tests/audioseal_reference.py``, plain torch,
nothing of the port) on seeded random weights, at a small size on the CPU:
``n_filters`` 4, ``dimension`` 8, ratios (2, 2), two LSTM layers.

Tolerances (readings on this CPU over the seeds and lengths below; the
control is the reference with every product rounded to TF32, which fails
each of them):

- ``RES_TOL``, the residual's (or the raw logits') largest gap over the
  reference's peak: 1e-5. f32 on both sides, summed in other orders (the
  weight norm refolded, the detector's two products folded into one,
  oneDNN's convs and LSTM against plain convs and a loop of products):
  3.4e-7 to 5.9e-7. TF32 reads 5.8e-4 to 1.5e-3.
- ``PROB_TOL``, the largest gap of a probability (a bit's, a sample's
  presence): 1e-6. The port reads 3e-8 to 1.8e-7; TF32 reads 2.9e-5 to
  3.4e-4.
- ``LSTM_TOL``, the LSTM module alone (1 and 37 frames), gap over the
  reference output's peak: 5e-7. The port reads 6e-9 to 7.2e-8; TF32
  reads 1.7e-6 to 5.2e-6.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import audioseal_reference as ra
from waveverify_torch import WaveVerify, spans
from waveverify_torch.api.audio_io import load_audio, save_audio
from waveverify_torch.config import AudioSealConfig
from waveverify_torch.convert import convert_audioseal, fuse_weight_g_v
from waveverify_torch.models.audioseal import (
    AudioSealModels,
    MsgProcessor,
    init_audioseal,
)
from waveverify_torch.modules.audiocraft import StreamableLSTM

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("pb_reference_ops",
                                               REPO / "portbench" / "reference" / "ops.py")
_ops = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ops)
F32, TF32 = _ops.Ops(), _ops.Ops(tf32=True)

RES_TOL, PROB_TOL, LSTM_TOL = 1e-5, 1e-6, 5e-7
SEEDS = (0, 1, 2)
LENGTHS = (800, 1001)  # a multiple of the hop (4), and not
SMALL = dict(n_filters=4, dimension=8, ratios=(2, 2), lstm=2, output_dim=8)
CFG = AudioSealConfig(**SMALL)
REF = {**ra.FIXED, "dimension": 8, "n_filters": 4, "n_residual_layers": 1, "ratios": [2, 2],
       "kernel_size": 7, "last_kernel_size": 7, "residual_kernel_size": 3,
       "dilation_base": 2, "compress": 2, "lstm": 2, "nbits": 16, "output_dim": 8}
CARD = {"nbits": 16, "seanet": {
    "activation": "ELU", "activation_params": {"alpha": 1.0}, "causal": False, "channels": 1,
    "compress": 2, "dilation_base": 2, "dimension": 128, "disable_norm_outer_blocks": 0,
    "kernel_size": 7, "last_kernel_size": 7, "lstm": 2, "n_filters": 32,
    "n_residual_layers": 1, "norm": "weight_norm", "norm_params": {}, "pad_mode": "constant",
    "ratios": [8, 5, 4, 2], "residual_kernel_size": 3, "true_skip": True}}


def state_dicts(seed):
    return ra.make_state_dicts(REF, torch.Generator().manual_seed(seed), "cpu")


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def port_models(seed, cfg=CFG):
    """The port's modules carrying the reference's weights of ``seed``."""
    models = AudioSealModels(cfg)
    sd_g, sd_d = state_dicts(seed)
    flat = convert_audioseal(fuse_weight_g_v(_np(sd_g)), fuse_weight_g_v(_np(sd_d)), models)
    models.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    return models.eval()


def clips(seed, length, b=2):
    g = np.random.default_rng(seed + 100)
    t = np.arange(length) / 16000.0
    audio = 0.3 * np.sin(2 * np.pi * g.uniform(100, 300, (b, 1)) * t) + 0.05 * g.standard_normal(
        (b, length))
    return audio.astype(np.float32), g.integers(0, 2, (b, 16)).astype(np.float32)


def gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def rel_gap(a, ref):
    return gap(a, ref) / float(np.max(np.abs(np.asarray(ref))))


def save_pair(tmp_path, sd_g, sd_d):
    paths = [tmp_path / "generator_base.pth", tmp_path / "detector_base.pth"]
    torch.save(sd_g, paths[0])
    torch.save(sd_d, paths[1])
    return paths


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("frames", [1, 37])
def test_lstm_against_the_loop(seed, frames):
    g = torch.Generator().manual_seed(seed)
    p = {k: (torch.rand(s, generator=g) * 2 - 1) / 8 for k, s, *_ in ra._lstm_spec("l", 16, 2)}
    x = torch.randn(3, 16, frames, generator=g)
    m = StreamableLSTM(16, num_layers=2)
    m.load_state_dict({"lstm." + k[2:]: v for k, v in p.items()})
    with torch.no_grad():
        got = m(x)
    want = ra.lstm(F32, p, "l", x, 2)
    assert got.shape == want.shape == x.shape
    assert rel_gap(got, want) < LSTM_TOL
    assert rel_gap(ra.lstm(TF32, p, "l", x, 2), want) > LSTM_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_msg_processor(seed):
    g = torch.Generator().manual_seed(seed)
    m = MsgProcessor(16, 8)
    with torch.no_grad():
        m.msg_processor.weight.copy_(torch.randn(32, 8, generator=g))
    hidden = torch.randn(3, 8, 5, generator=g)
    msg = torch.randint(0, 2, (3, 16), generator=g).float()
    want = ra.msg_processor({"msg_processor.msg_processor.weight": m.msg_processor.weight},
                            hidden, msg)
    with torch.no_grad():
        got = m(hidden, msg)
    assert torch.equal(got, want)
    # bit k picks row 2k + bit: flipping one bit moves every frame by a row difference
    flip = msg.clone()
    flip[0, 3] = 1 - flip[0, 3]
    with torch.no_grad():
        moved = m(hidden, flip) - got
    w = m.msg_processor.weight
    step = w[7] - w[6] if msg[0, 3] == 0 else w[6] - w[7]
    assert torch.allclose(moved[0], step[:, None].expand(8, 5), atol=1e-6)
    assert torch.equal(moved[1:], torch.zeros_like(moved[1:]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_generator_residual(seed, length):
    models = port_models(seed)
    sd_g, _ = state_dicts(seed)
    audio, bits = clips(seed, length)
    with torch.no_grad():
        got = models.apply_generator(torch.from_numpy(audio), torch.from_numpy(bits))
    want = ra.watermark(F32, sd_g, REF, torch.from_numpy(audio), torch.from_numpy(bits))
    assert got.shape == (2, length)
    assert rel_gap(got, want) < RES_TOL


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_detector_presence_and_message(seed, length):
    models = port_models(seed)
    _, sd_d = state_dicts(seed)
    audio, _ = clips(seed, length)
    x = torch.from_numpy(audio)
    with torch.no_grad():
        logits = models.apply_detector(x)
        presence = torch.sigmoid(models.apply_locator(x))
    presence_ref, msg_ref = ra.detect(F32, sd_d, REF, x)
    assert logits.shape == (2, length, 18)
    assert gap(presence, presence_ref) < PROB_TOL
    assert gap(torch.sigmoid(logits[..., 2:].mean(dim=1)), msg_ref) < PROB_TOL
    # the raw outputs, channel by channel
    raw = ra.detector_logits(F32, sd_d, REF, x).transpose(1, 2)
    assert rel_gap(logits, raw) < RES_TOL


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_waveverify_serves_audioseal(seed, length, tmp_path):
    """``embed_batch`` / ``detect_batch`` / ``embed`` / ``detect_array`` /
    ``locate_array`` under an ``AudioSealConfig``, weights from AudioSeal's
    two state dicts."""
    sd_g, sd_d = state_dicts(seed)
    wv = WaveVerify(save_pair(tmp_path, sd_g, sd_d), config=CFG, device="cpu")
    assert wv.models.whole_input and wv.sample_rate == 16000 and wv.hop == 4
    audio, bits = clips(seed, length)
    wm = wv.embed_batch(audio, bits)
    res = ra.watermark(F32, sd_g, REF, torch.from_numpy(audio), torch.from_numpy(bits))
    assert rel_gap(wm - audio, res) < RES_TOL
    got_bits, score = wv.detect_batch(wm)
    presence, msg = ra.detect(F32, sd_d, REF, torch.from_numpy(wm))
    sure = np.abs(msg.numpy() - 0.5) > 1e-3
    assert np.array_equal(got_bits[sure], (msg.numpy() > 0.5).astype(int)[sure])
    # the detection score: the share of samples whose presence passes 0.5
    assert gap(score, (presence > 0.5).float().mean(dim=1)) <= 1.0 / length
    probs, _ = wv._detect_on(wv.models, wv.device, wm, length)
    assert gap(probs, msg) < PROB_TOL
    # one clip: no bucket padding (AudioSeal is not causal), the id's bits
    ident, conf = wv.detect_array(wm[0])
    assert len(ident.to_bits()) == 16 and 0.0 <= conf <= 1.0
    assert gap(wv.locate_array(wm[0]), presence[0]) < PROB_TOL
    one = ra.detect(F32, sd_d, REF, torch.from_numpy(wm[:1]))
    assert conf == pytest.approx(float((one[0] > 0.5).float().mean()), abs=1.0 / length)


def test_embed_one_file_runs_whole(tmp_path):
    """``embed`` of a file and a clip over ``long_threshold``: neither is
    padded to a bucket nor cut into windows."""
    sd_g, sd_d = state_dicts(0)
    wv = WaveVerify(save_pair(tmp_path, sd_g, sd_d), config=CFG, device="cpu")
    wv.long_threshold = 500
    audio, _ = clips(0, 1001, b=1)
    path = tmp_path / "clip.wav"
    save_audio(audio[0], path, 16000)
    out, sr, ident = wv.embed(path, 0x1234)
    bits = torch.tensor([[float(c) for c in ident.to_bits()]])
    read = torch.from_numpy(np.asarray(load_audio(path, 16000)[0], np.float32).reshape(1, -1))
    res = ra.watermark(F32, sd_g, REF, read, bits)
    assert sr == 16000 and out.shape == (1001,)
    assert rel_gap(out - read[0].numpy(), res[0]) < RES_TOL
    presence, _ = ra.detect(F32, sd_d, REF, torch.from_numpy(out[None]))
    assert gap(wv.locate_array(out), presence[0]) < PROB_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_fails_a_tolerance(seed):
    """The control: the reference with its products in TF32 in the port's
    place fails the residual's tolerance and the probabilities'."""
    sd_g, sd_d = state_dicts(seed)
    audio, bits = clips(seed, 1001)
    a, m = torch.from_numpy(audio), torch.from_numpy(bits)
    assert rel_gap(ra.watermark(TF32, sd_g, REF, a, m), ra.watermark(F32, sd_g, REF, a, m)) \
        > RES_TOL
    (p_low, m_low), (p_ref, m_ref) = ra.detect(TF32, sd_d, REF, a), ra.detect(F32, sd_d, REF, a)
    assert max(gap(p_low, p_ref), gap(m_low, m_ref)) > PROB_TOL


def test_published_parameter_counts():
    """The cards' widths: 14.68 M parameters in the generator, 8.65 M in
    the detector (weight-norm gains and biases included), each LSTM 4.2 M;
    the reference's trees hold the same."""
    models = AudioSealModels(AudioSealConfig())
    n_g = sum(p.numel() for p in models.generator.parameters())
    n_d = sum(p.numel() for p in models.detector.parameters())
    assert (n_g, n_d) == (14679906, 8649138)
    lstm = models.generator.encoder.model[13]
    assert isinstance(lstm, StreamableLSTM)
    assert sum(p.numel() for p in lstm.parameters()) == 4202496
    full = {**ra.FIXED, **CARD["seanet"], "nbits": 16, "output_dim": 32}
    assert sum(math.prod(s) for _, s, *_ in ra.generator_spec(full)) == n_g
    assert sum(math.prod(s) for _, s, *_ in ra.detector_spec(full)) == n_d


def test_config_from_cards():
    wm = {**CARD, "decoder": {"final_activation": None, "final_activation_params": None,
                              "trim_right_ratio": 1.0}}
    det = {**CARD, "detector": {"output_dim": 32}}
    assert AudioSealConfig.from_card(wm, det) == AudioSealConfig()
    assert AudioSealConfig.from_card(det, {"alpha": 0.5}).alpha == 0.5
    other = {"nbits": 16, "seanet": {**CARD["seanet"], "n_filters": 16}}
    with pytest.raises(ValueError, match="n_filters"):
        AudioSealConfig.from_card(wm, other)


def _layouts(sd):
    """AudioSeal's state dict as ``weight_norm`` writes it, as a
    parametrization writes it, fused, wrapped, and with a ``module.``
    prefix."""
    out = {"weight_g_v": sd, "wrapped": {"model": sd, "xp.cfg": "card"},
           "module": {"module." + k: v for k, v in sd.items()}}
    para, fused = {}, {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[:-len(".weight_v")]
            g = sd[base + ".weight_g"]
            para[base + ".parametrizations.weight.original0"] = g
            para[base + ".parametrizations.weight.original1"] = v
            fused[base + ".weight"] = g * v / torch.sqrt(torch.sum(v * v, dim=(1, 2),
                                                                   keepdim=True))
        else:
            para[k] = fused[k] = v
    out["parametrizations"], out["fused"] = para, fused
    return out


@pytest.mark.parametrize("layout", ["weight_g_v", "parametrizations", "fused", "wrapped",
                                    "module"])
def test_state_dict_layouts_load_and_serve_the_same(layout, tmp_path):
    sd_g, sd_d = state_dicts(1)
    paths = save_pair(tmp_path, _layouts(sd_g)[layout], _layouts(sd_d)[layout])
    wv = WaveVerify(paths, config=CFG, device="cpu")
    audio, bits = clips(1, 1001)
    res = ra.watermark(F32, sd_g, REF, torch.from_numpy(audio), torch.from_numpy(bits))
    wm = wv.embed_batch(audio, bits)
    assert rel_gap(wm - audio, res) < RES_TOL
    presence, _ = ra.detect(F32, sd_d, REF, torch.from_numpy(wm))
    assert gap(wv.locate_array(wm[1]), presence[1]) < PROB_TOL


@pytest.mark.parametrize("fault,error", [("missing", KeyError), ("extra", KeyError),
                                         ("misshapen", ValueError), ("one_tree_twice", KeyError)])
def test_bad_state_dicts_raise(fault, error, tmp_path):
    sd_g, sd_d = (dict(sd) for sd in state_dicts(0))
    if fault == "missing":
        del sd_d["detector.1.bias"]
    elif fault == "extra":
        sd_g["decoder.model.99.conv.conv.bias"] = torch.zeros(3)
    elif fault == "misshapen":
        sd_g["encoder.model.7.lstm.bias_ih_l1"] = torch.zeros(3)
    else:
        sd_d = sd_g
    with pytest.raises(error):
        WaveVerify(save_pair(tmp_path, sd_g, sd_d), config=CFG, device="cpu")


def test_random_init_is_pytorchs_default():
    """No checkpoint: PyTorch's default initialisers drawn from the seed on
    a CPU generator; weight norm's gain is ||v||, so the kernel is v."""
    wv = WaveVerify(config=CFG, seed=5, device="cpu")
    again = WaveVerify(config=CFG, seed=5, device="cpu").models.state_dict()
    other = WaveVerify(config=CFG, seed=6, device="cpu").models.state_dict()
    sd = wv.models.state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["generator.decoder.model.0.conv.v"],
                           other["generator.decoder.model.0.conv.v"])
    for name, m in wv.models.named_modules():
        if hasattr(m, "v"):
            bound = 1 / math.sqrt(math.prod(m.v.shape[1:]))
            assert m.v.abs().max() <= bound and m.v.abs().max() > 0.5 * bound, name
            if m.g is not None:
                assert torch.allclose(m.weight(), m.v, atol=1e-6), name
        elif isinstance(m, torch.nn.LSTM):
            for p in m.parameters():
                assert p.abs().max() <= 1 / math.sqrt(m.hidden_size)
    emb = wv.models.generator.msg_processor.msg_processor.weight
    assert 0.6 < float(emb.std()) < 1.4
    audio, bits = clips(0, 800)
    assert np.all(np.isfinite(wv.embed_batch(audio, bits)))


def test_init_audioseal_draws_every_parameter():
    models = AudioSealModels(CFG)
    for p in models.parameters():
        torch.nn.init.constant_(p, float("nan"))
    init_audioseal(models, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in models.parameters())


def test_alpha_scales_the_residual(tmp_path):
    sd_g, sd_d = state_dicts(2)
    paths = save_pair(tmp_path, sd_g, sd_d)
    audio, bits = clips(2, 800)
    one = WaveVerify(paths, config=CFG, device="cpu").embed_batch(audio, bits) - audio
    half = AudioSealConfig(**SMALL, alpha=0.5)
    got = WaveVerify(paths, config=half, device="cpu").embed_batch(audio, bits) - audio
    assert rel_gap(got, 0.5 * one) < RES_TOL


def test_bf16_serving_keeps_the_recurrence_in_f32(tmp_path):
    """``serve_dtype="bfloat16"``: the convs in bf16, the LSTM in f32; the
    residual within 5% of its peak (bf16 keeps 8 bits of mantissa), the
    message probabilities within 1e-2."""
    sd_g, sd_d = state_dicts(0)
    wv = WaveVerify(save_pair(tmp_path, sd_g, sd_d), config=CFG, serve_dtype="bfloat16",
                    device="cpu")
    audio, bits = clips(0, 1001)
    wm = wv.embed_batch(audio, bits)
    res = ra.watermark(F32, sd_g, REF, torch.from_numpy(audio), torch.from_numpy(bits))
    assert wm.dtype == np.float32 and rel_gap(wm - audio, res) < 5e-2
    probs, _ = wv._detect_on(wv.models, wv.device, wm, 1001)
    assert gap(probs, ra.detect(F32, sd_d, REF, torch.from_numpy(wm))[1]) < 1e-2


def test_lstm_spans():
    """Under a profiler each LSTM call records a ``seanet.lstm`` span, inside
    the API's generator and detector spans: three per embed+detect."""
    wv = WaveVerify(config=CFG, seed=0, device="cpu")
    audio, bits = clips(0, 800)
    spans.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        wv.detect_batch(wv.embed_batch(audio, bits))
    records, dropped = spans.drain()
    by_id = {r["id"]: r for r in records}
    lstm = [r for r in records if r["name"] == "seanet.lstm"]
    assert dropped == 0 and len(lstm) == 3
    assert [by_id[r["parent"]]["name"] for r in lstm] == ["api.generator"] * 2 + ["api.detector"]
    wv.detect_batch(wv.embed_batch(audio, bits))
    assert spans.drain() == ([], 0)


def test_the_reference_has_one_text():
    """``tests/audioseal_reference.py`` is ``portbench/reference/audioseal.py``."""
    here = (REPO / "tests" / "audioseal_reference.py").read_bytes()
    assert here == (REPO / "portbench" / "reference" / "audioseal.py").read_bytes()


# -- on the card -----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_lstm_graphs_on_the_card():
    """A shape's first call runs cuDNN's LSTM as it is; from the second on
    a CUDA graph of the same call is replayed, with the same output; the
    module captures the first ``GRAPHS`` shapes that recur, keeps them
    while later shapes run as they are, and forgets them when it moves."""
    dev = _card()
    m = StreamableLSTM(64).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 64, 300, generator=g, device=dev)
    with torch.no_grad():
        eager = m(x)
        assert not m._graphs
        graphed, again = m(x), m(2 * x)
        assert len(m._graphs) == 1
        want = m.lstm((2 * x).permute(2, 0, 1))[0] + (2 * x).permute(2, 0, 1)
        for t in range(m.GRAPHS + 1):
            for _ in range(2):
                m(x[..., :10 + t])
        held = set(m._graphs)
        late = x[..., :10 + m.GRAPHS]
        over = m(late)
        over_want = m.lstm(late.permute(2, 0, 1))[0] + late.permute(2, 0, 1)
    peak = float(eager.abs().max())
    assert float((graphed - eager).abs().max()) <= 1e-6 * peak
    assert float((again - want.permute(1, 2, 0)).abs().max()) <= 1e-6 * peak
    assert float((over - over_want.permute(1, 2, 0)).abs().max()) <= 1e-6 * peak
    assert len(m._graphs) == m.GRAPHS and set(m._graphs) == held
    assert ((300, 4, 64), x.device) in m._graphs
    m.cpu()
    assert not m._graphs and not m._seen


@pytest.mark.cuda
def test_waveverify_serves_audioseal_on_the_card(tmp_path):
    """``embed_batch`` / ``detect_batch`` / ``locate_array`` on the card
    against the reference, with the tolerances above, on calls that replay
    the LSTMs' graphs."""
    dev = _card()
    sd_g, sd_d = state_dicts(1)
    wv = WaveVerify(save_pair(tmp_path, sd_g, sd_d), config=CFG, device="cuda")
    audio, bits = clips(1, 4001)
    for _ in range(3):
        wm = wv.embed_batch(audio, bits)
        got_bits, _ = wv.detect_batch(wm)
    res = ra.watermark(F32, sd_g, REF, torch.from_numpy(audio), torch.from_numpy(bits))
    assert rel_gap(wm - audio, res) < RES_TOL
    presence, msg = ra.detect(F32, sd_d, REF, torch.from_numpy(wm))
    probs, _ = wv._detect_on(wv.models, dev, wm, wm.shape[-1])
    assert gap(probs.cpu(), msg) < PROB_TOL
    lstms = [m for m in wv.models.modules() if isinstance(m, StreamableLSTM)]
    assert len(lstms) == 3 and all(len(m._graphs) == 1 for m in lstms)
    for row in range(2):
        assert gap(wv.locate_array(wm[row]), presence[row]) < PROB_TOL
