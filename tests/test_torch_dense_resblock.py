"""The fused dense residual block (``waveverify_torch/ops/dense_resblock.py``,
``csrc/dense_resblock.cu``) and its dispatch in AudioSeal's
``SEANetResnetBlock`` (``modules/audiocraft.py``): the plan, the weights'
fragment order, the plain version against the module's ops and the
dispatch's refusals on the CPU; on the card the kernel against the plain
version and one whole AudioSeal embed + detect on the kernel against the
plain path.

``REF_TOL``: the plain version against the module's ops (cuDNN's or
oneDNN's convs, summed in another order), the gap over the output's peak.
``KERNEL_TOL``: the kernel against the plain version, the same gap: split
TF32 (three passes, a_lo b_lo dropped, the sums in f32) against f32
products; one TF32 pass fails it.

The file imports no JAX: the card tests run with ``python -m pytest
--noconftest -q -m cuda tests/test_torch_dense_resblock.py`` on a machine
with an H100.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import audioseal_reference as ra
from waveverify_torch import WaveVerify, spans
from waveverify_torch.config import AudioSealConfig
from waveverify_torch.modules.audiocraft import SEANetResnetBlock
from waveverify_torch.modules.conv import init_params
from waveverify_torch.ops import dense_resblock as dr

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
REF_TOL = 1e-6
KERNEL_TOL = 5e-6
WIDTHS = (32, 64, 128, 256)


def block(c, dilation=1, norm="weight_norm", seed=0, **kw):
    """AudioSeal's residual block at width ``c`` (constant padding, not
    causal, identity shortcut unless ``kw`` says otherwise), its weights
    drawn from ``seed`` with non-zero biases and gains off 1."""
    opts = dict(norm=norm, pad_mode="constant", causal=False)
    opts.update(kw)
    m = SEANetResnetBlock(c, (3, 1), (dilation, 1), **opts)
    g = torch.Generator().manual_seed(seed)
    init_params(m, g)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return m.eval()


def effective(m):
    """The plain version's arguments from a block: the convs' weights."""
    c1, c2 = m.block[1].conv, m.block[3].conv
    return c1.weight(), c1.b, c2.weight(), c2.b


def rel_gap(a, ref):
    a, ref = a.double().cpu(), ref.double().cpu()
    return float((a - ref).abs().max() / ref.abs().max())


def inputs(b, c, t, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, c, t, generator=g, device=device)


# -- the plan and the fragment order ----------------------------------------------------


@pytest.mark.parametrize("c,tiling,rows,slab", [
    (32, 0, 256, 33792), (64, 0, 128, 34816), (128, 1, 128, 69632), (256, 1, 64, 73728)])
def test_plan_at_the_published_widths(c, tiling, rows, slab):
    """Each of AudioSeal's widths has a tiling; the slab's stride is 8 mod
    32 and holds the tile and its halo, and h over it; two CTAs fit an SM;
    the second product runs in two passes."""
    plan = dr.resblock_plan(c, 3, 1)
    assert (plan.tiling, plan.rows, plan.smem) == (tiling, rows, slab)
    assert plan.ld % 32 == 8 and plan.ldh % 32 == 8 and plan.hp == 4
    assert plan.ld >= plan.rows + 2 * plan.hp and 2 * plan.smem <= dr.H100_SMEM
    nt1, mt1, nt2, mt2 = dr.TILINGS[tiling]
    assert (c // 2) % (8 * nt1) == 0 and c % (8 * nt2) == 0
    assert dr.tiling_rows(c, tiling) == rows == 2 * (8 // (c // (8 * nt2))) * mt2 * 16


@pytest.mark.parametrize("k,dilation,hp", [(3, 1, 4), (3, 4, 4), (3, 5, 8), (7, 3, 12)])
def test_plan_rounds_the_halo_up_to_4(k, dilation, hp):
    """The slab starts hp >= d (k - 1) / 2 samples before the tile, hp a
    multiple of 4 (whole 16-byte copies), and holds the tile and both
    halos."""
    plan = dr.resblock_plan(64, k, dilation)
    assert plan.hp == hp >= dilation * (k - 1) // 2
    assert plan.ld == dr.slab_stride(plan.rows + 2 * hp) and plan.smem == 4 * 64 * plan.ld


def test_source_compiles_the_tilings():
    """The kernel source compiles the tilings of :data:`TILINGS`, in their
    order: the plan's tiling index picks the instantiation."""
    src = (REPO / "waveverify_torch" / "csrc" / "dense_resblock.cu").read_text()
    table = re.search(r"#define WV_DR_TILINGS\(X\) (.*)", src).group(1)
    compiled = [tuple(int(v) for v in m.split(",")[:4]) for m in re.findall(r"X\(([^)]*)\)", table)]
    assert compiled == list(dr.TILINGS)
    assert set(dr.WIDTH_TILING.values()) <= set(range(len(dr.TILINGS)))


@pytest.mark.parametrize("c,k,dilation", [(48, 3, 1), (512, 3, 1), (16, 3, 1), (64, 2, 1),
                                          (64, 3, 0), (256, 3, 2000)])
def test_no_plan(c, k, dilation):
    """Widths without a tiling, an even kernel, a dilation of 0, a halo
    whose slab does not fit: no plan."""
    assert dr.resblock_plan(c, k, dilation) is None


@pytest.mark.parametrize("n,k_in,taps", [(16, 32, 3), (32, 16, 1), (128, 256, 3)])
def test_pack_weights_fragment_order(n, k_in, taps):
    """Lane l = 4 g + t of k-step ks and n-tile pair p finds the hi of B[8 ks
    + t][16 p + g], B[8 ks + t + 4][16 p + g], B[8 ks + t][16 p + 8 + g],
    B[8 ks + t + 4][16 p + 8 + g] at float4 (ks N / 16 + p) 64 + l and
    their lo 32 float4 further, B[j K_in + ci][o] = w[o][ci][j]; hi is the
    value rounded to TF32 and hi + lo the value."""
    w = torch.randn(n, k_in, taps)
    flat = dr.pack_weights(w, taps).reshape(-1, 4)
    bmat = w.permute(2, 1, 0).reshape(taps * k_in, n)
    ks, p, lane = np.meshgrid(np.arange(taps * k_in // 8), np.arange(n // 16), np.arange(32),
                              indexing="ij")
    g, t = lane // 4, lane % 4
    idx = torch.from_numpy(((ks * (n // 16) + p) * 64 + lane).ravel())
    rows, cols = 8 * ks + t, 16 * p + g
    for e, (dr_, dc) in enumerate([(0, 0), (4, 0), (0, 8), (4, 8)]):
        want = bmat[torch.from_numpy((rows + dr_).ravel()), torch.from_numpy((cols + dc).ravel())]
        hi, lo = flat[idx, e], flat[idx + 32, e]
        assert torch.equal(hi, dr.round_tf32(want)) and torch.equal(hi + lo, want)
        assert (lo.abs() <= want.abs() * 2.0 ** -11).all()


# -- the plain version -----------------------------------------------------------------


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("t", [1, 2, 3, 127, 4001])
def test_ref_matches_the_module(c, t):
    m = block(c, seed=c + t)
    x = inputs(1, c, t, seed=t)
    with torch.no_grad():
        want = m(x)
        got = dr.dense_resblock_ref(x, *effective(m))
    assert got.shape == want.shape == x.shape
    assert rel_gap(got, want) < REF_TOL


@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("norm", ["weight_norm", "none"])
def test_ref_matches_the_module_dilated(dilation, norm):
    m = block(64, dilation, norm, seed=dilation)
    x = inputs(2, 64, 301, seed=dilation)
    with torch.no_grad():
        want = m(x)
        got = dr.dense_resblock_ref(x, *effective(m), dilation=dilation)
    assert rel_gap(got, want) < REF_TOL


def test_tf32_control_fails_the_kernel_tolerance():
    """One TF32 pass of the plain version's products reads far over
    KERNEL_TOL; rounding is what it changes."""
    m = block(64)
    x = inputs(2, 64, 300)
    with torch.no_grad():
        want = dr.dense_resblock_ref(x, *effective(m))
        control = dr.dense_resblock_ref(x, *effective(m), tf32=True)
    assert rel_gap(control, want) > 10 * KERNEL_TOL
    assert torch.equal(dr.round_tf32(torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -12])),
                       torch.tensor([1.0, 1 + 2.0 ** -10, 1.0]))


def test_ref_alpha():
    """ELU's alpha reaches both activations."""
    m = block(32, activation_params={"alpha": 0.5})
    x = inputs(2, 32, 50)
    with torch.no_grad():
        want = m(x)
        got = dr.dense_resblock_ref(x, *effective(m), alpha=0.5)
        other = dr.dense_resblock_ref(x, *effective(m), alpha=1.0)
    assert rel_gap(got, want) < REF_TOL < rel_gap(other, want)


# -- the dispatch ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["causal", "reflect", "shortcut", "activation", "compress",
                                  "even_kernel", "no_bias", "layer_norm"])
def test_form_declines(case):
    """Blocks the kernel does not compute keep their modules; AudioSeal's
    own takes it, with or without weight norm and at any dilation."""
    kw = {"causal": dict(causal=True), "reflect": dict(pad_mode="reflect"),
          "shortcut": dict(true_skip=False), "activation": dict(activation="LeakyReLU"),
          "compress": dict(compress=4), "even_kernel": {}, "no_bias": {},
          "layer_norm": dict(norm="layer_norm")}[case]
    if case == "even_kernel":
        m = SEANetResnetBlock(64, (4, 1), (1, 1), pad_mode="constant")
    else:
        m = block(64, **kw)
    if case == "no_bias":
        m.block[3].conv.b = None
    assert m._fused_form(64) is False
    assert block(64)._fused_form(64) and block(64, 4, "none")._fused_form(64)


@pytest.mark.parametrize("case", ["grad", "bf16", "cpu"])
def test_cpu_runs_the_modules(case):
    """On the CPU, under autograd and in bf16 the block runs its modules:
    no launch."""
    m = block(32)
    x = inputs(2, 32, 40)
    before = dr.dense_resblock.launches
    if case == "bf16":
        m, x = m.to(torch.bfloat16), x.to(torch.bfloat16)
    if case == "grad":
        y = m(x)
        assert y.requires_grad
    else:
        with torch.no_grad():
            y = m(x)
    assert m._fused_plan(x) is None
    assert y.dtype == x.dtype and dr.dense_resblock.launches == before == 0
    assert dr.pack_on_card.launches == 0


def test_resblock_spans():
    """Under a profiler each block records a ``seanet.resblock`` span,
    inside the API's generator and detector spans; on the CPU none holds a
    ``resblock.fused`` child."""
    cfg = AudioSealConfig(n_filters=4, dimension=8, ratios=(2, 2), lstm=2, output_dim=8)
    wv = WaveVerify(config=cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 800)) * 0.1).astype(np.float32)
    bits = rng.integers(0, 2, (2, 16)).astype(np.float32)
    spans.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        wv.detect_batch(wv.embed_batch(audio, bits))
    records, dropped = spans.drain()
    by_id = {r["id"]: r for r in records}
    blocks = [r for r in records if r["name"] == "seanet.resblock"]
    assert dropped == 0 and len(blocks) == 6
    assert [by_id[r["parent"]]["name"] for r in blocks] == (["api.generator"] * 4
                                                            + ["api.detector"] * 2)
    assert not [r for r in records if r["name"] == dr.SPAN]


# -- on the card -----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dilation", [1, 3])
def test_kernel_against_the_plain_version(c, dilation):
    dev = _card()
    m = block(c, dilation, seed=c).to(dev)
    x = inputs(2, c, 3001, seed=c, device=dev)
    with torch.no_grad():
        args = effective(m)
        before = dr.dense_resblock.launches, dr.pack_on_card.launches
        got = m(x)
        torch.cuda.synchronize()
        assert dr.dense_resblock.launches - before[0] == 1
        assert dr.pack_on_card.launches - before[1] == 2
        want = dr.dense_resblock_ref(x, *args, dilation=dilation)
        control = dr.dense_resblock_ref(x, *args, dilation=dilation, tf32=True)
    gap = rel_gap(got, want)
    print(f"C={c} d={dilation}: kernel gap {gap:.2e}, TF32 control {rel_gap(control, want):.2e}")
    assert gap < KERNEL_TOL < rel_gap(control, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("c,t", [(32, 1), (64, 2), (128, 3), (256, 63), (256, 65), (128, 129),
                                 (64, 130), (32, 257), (32, 480000)])
def test_kernel_lengths(b, c, t):
    """Lengths shorter than the halo, around a tile's edge, odd ones (4-byte
    loads) and a 30 s clip at 16 kHz."""
    dev = _card()
    m = block(c, seed=t).to(dev)
    x = inputs(b, c, t, seed=t, device=dev)
    with torch.no_grad():
        got = m(x)
        want = dr.dense_resblock_ref(x, *effective(m))
    assert rel_gap(got, want) < KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,k_in,taps", [(16, 32, 3), (32, 16, 1), (128, 256, 3),
                                         (256, 128, 1)])
def test_pack_on_the_card(n, k_in, taps):
    """The library's pack kernel writes :func:`pack_weights`' image, one
    launch each."""
    dev = _card()
    w = torch.randn(n, k_in, taps, device=dev)
    before = dr.pack_on_card.launches
    assert torch.equal(dr.pack_on_card(w, taps), dr.pack_weights(w, taps))
    assert dr.pack_on_card.launches - before == 1


@pytest.mark.cuda
def test_kernel_declines_on_the_card():
    """Under autograd, in bf16 and with a causal block the card runs the
    modules: no launch."""
    dev = _card()
    m = block(64).to(dev)
    x = inputs(2, 64, 100, device=dev)
    before = dr.dense_resblock.launches
    assert m(x).requires_grad
    with torch.no_grad():
        m.to(torch.bfloat16)(x.to(torch.bfloat16))
        block(64, causal=True).to(dev)(x)
    assert dr.dense_resblock.launches == before


@pytest.mark.cuda
def test_audioseal_on_the_kernel_against_the_plain_path(tmp_path, monkeypatch):
    """AudioSeal at the published widths (weights drawn as the benchmark
    draws them) serving 2 clips of 2 s on the kernel against the same
    models on the blocks' modules, held to the AudioSeal cell's limits:
    wm_gap 2e-5, msg_gap 1e-6, presence_gap 5e-5, no bit flipped where the
    plain path's probability is 1e-3 or more from 0.5. Each network runs 4
    block launches, each with 2 pack launches."""
    dev = _card()
    model = json.loads((REPO / "portbench" / "configs" / "audioseal_16bits.json").read_text())[
        "model"]
    cfg_ref = {**model["generator"]["seanet"], **model["generator"]["decoder"],
               "nbits": 16, "output_dim": model["detector"]["detector"]["output_dim"]}
    sd_g, sd_d = ra.make_state_dicts(cfg_ref, torch.Generator().manual_seed(5), "cpu")
    paths = [tmp_path / "generator.pth", tmp_path / "detector.pth"]
    torch.save(sd_g, paths[0])
    torch.save(sd_d, paths[1])
    config = AudioSealConfig.from_card(model["generator"], model["detector"],
                                       {"sample_rate": 16000, "alpha": 1.0})
    wv = WaveVerify(paths, config=config, device="cuda")
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((2, 32000)) * 0.1).astype(np.float32)
    bits = rng.integers(0, 2, (2, 16)).astype(np.float32)

    def serve():
        before = dr.dense_resblock.launches, dr.pack_on_card.launches
        wm = wv.embed_batch(audio, bits)
        probs, _ = wv._detect_on(wv.models, dev, wm, wm.shape[-1])
        presence = np.stack([wv.locate_array(row) for row in wm])
        return wm, probs.cpu().numpy(), presence, (dr.dense_resblock.launches - before[0],
                                                   dr.pack_on_card.launches - before[1])

    wm_k, _, _, launches = serve()
    blocks = 2 * 4 + 4 + 2 * 4  # embed, detect, locate each row
    assert launches == (blocks, 2 * blocks)
    monkeypatch.setattr(SEANetResnetBlock, "_fused_plan", lambda self, x: None)
    wm_p, probs_p, presence_p, launches = serve()
    assert launches == (0, 0)
    monkeypatch.undo()
    # the detector on the same audio both ways
    probs_k, _ = wv._detect_on(wv.models, dev, wm_p, wm_p.shape[-1])
    presence_k = np.stack([wv.locate_array(row) for row in wm_p])
    probs_k = probs_k.cpu().numpy()
    res = wm_p - audio
    wm_gap = float(np.abs(wm_k - wm_p).max() / np.abs(res).max())
    msg_gap = float(np.abs(probs_k - probs_p).max())
    presence_gap = float(np.abs(presence_k - presence_p).max())
    sure = np.abs(probs_p - 0.5) > 1e-3
    print(f"AudioSeal kernel vs plain path: wm_gap {wm_gap:.2e}, msg_gap {msg_gap:.2e}, "
          f"presence_gap {presence_gap:.2e}")
    assert wm_gap < 2e-5 and msg_gap < 1e-6 and presence_gap < 5e-5
    assert ((probs_k > 0.5) == (probs_p > 0.5))[sure].all()
