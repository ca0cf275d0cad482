"""The persistent LSTM recurrence (``waveverify_torch/ops/lstm_recurrence.py``,
``csrc/lstm_recurrence.cu``): its launch plan and its plain version on the
CPU, the kernel on the card, against the reference's loop of products
(``tests/audioseal_reference.py`` ``lstm``, plain torch).

``LSTM_TOL`` is ``test_torch_audioseal.py``'s: the gap over the reference
output's peak, 5e-7; the control (every product rounded to TF32) fails it.
The card tests run with ``python -m pytest --noconftest -q
tests/test_torch_lstm_recurrence.py`` on a machine with an H100.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from tests import audioseal_reference as ra
from waveverify_torch.modules.audiocraft import StreamableLSTM
from waveverify_torch.ops import lstm_recurrence as lr

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("pb_reference_ops",
                                               REPO / "portbench" / "reference" / "ops.py")
_ops = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ops)
F32, TF32 = _ops.Ops(), _ops.Ops(tf32=True)

LSTM_TOL = 5e-7
SEEDS = (0, 1, 2)


def lstm_params(seed, h, layers, scale=None, device="cpu", g=None):
    """Seeded LSTM weights under the reference's names ``l.*``: U(+-1/8) at
    small widths (as ``test_torch_audioseal.py``), PyTorch's U(+-1/sqrt(H))
    with ``scale=None`` at a card's."""
    g = g or torch.Generator().manual_seed(seed)
    bound = scale if scale is not None else h ** -0.5
    return {k: ((torch.rand(s, generator=g) * 2 - 1) * bound).to(device)
            for k, s, *_ in ra._lstm_spec("l", h, layers)}


def as_weights(p, layers):
    return [tuple(p[f"l.{n}_l{i}"] for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            for i in range(layers)]


def rel_gap(a, ref):
    a, ref = a.double().cpu(), ref.double().cpu()
    return float((a - ref).abs().max() / ref.abs().max())


# -- the plan --------------------------------------------------------------------------


@pytest.mark.parametrize("h,layers,units,ctas,smem", [
    (8, 2, (2, 1), (4, 8), 4928),
    (512, 2, (12, 6), (43, 86), 150912),
    (512, 3, (20, 10, 10), (26, 52, 52), 225152),
    (1024, 1, (8,), (128,), 179456),
])
def test_plan_at_widths(h, layers, units, ctas, smem):
    """On an H100: the first layer's CTAs own twice the units of the layers
    above (their input product is precomputed), every CTA one SM; one layer
    of 1024 fits one launch (two do not: no plan)."""
    plan = lr.lstm_plan(h, layers)
    assert (plan.units, plan.ctas, plan.smem) == (units, ctas, smem)
    assert sum(plan.ctas) <= lr.H100_SMS and plan.smem <= lr.H100_SMEM
    assert lr.smem_bytes(h, plan.units, plan.max_batch) <= lr.H100_SMEM
    assert lr.smem_bytes(h, plan.units, plan.max_batch + lr.BATCH_GROUP) > lr.H100_SMEM
    assert plan.max_batch % lr.BATCH_GROUP == 0
    for units_l, ctas_l in zip(plan.units, plan.ctas):
        cover = [u for u0, n in lr.unit_slices(h, units_l) for u in range(u0, u0 + n)]
        assert cover == list(range(h)) and len(lr.unit_slices(h, units_l)) == ctas_l


def test_plan_at_h512_splits_the_work_evenly():
    """AudioSeal's LSTM: 43 CTAs of 12 units (48 rows x 512) and 86 of 6 (24
    rows x 1024): the same FMA per CTA; 32 slices of 4 quads of k and 64 of
    2, so 384 threads sum; weights 96 KiB, the partial sums (over the staged
    h) 49.5 KiB, the gates 1.5 KiB, c 384 bytes at batch 8."""
    assert lr.geometry(512, 12) == (32, 4, 512, 32 * 12 + 12)
    assert lr.geometry(512, 6) == (64, 2, 512, 64 * 6 + 6)
    assert 4 * 12 * 512 == 4 * 6 * 1024
    assert lr.layer_smem(512, 0, 12, 8) == (24576, 32 * 396, 384, 96)
    assert lr.layer_smem(512, 1, 6, 8) == (24576, 32 * 390, 192, 48)
    assert lr.smem_bytes(512, (12, 6)) == 4 * (24576 + 32 * 396 + 384 + 96)


@pytest.mark.parametrize("h,units", [(512, 12), (512, 6), (8, 2), (100, 7), (1024, 8), (6, 1)])
def test_geometry_covers_h_with_whole_quads(h, units):
    slices, quads, padded, pstride = lr.geometry(h, units)
    assert slices * units <= lr.THREADS and padded == 4 * slices * quads
    assert padded >= h > padded - 4 * slices
    assert pstride >= slices * units and pstride % 32 == units % 32


@pytest.mark.parametrize("h,layers,sms,smem", [
    (2048, 2, 132, 232448),  # one layer's W_hh is 16 MiB: over the card's shared memory
    (2048, 1, 132, 232448),
    (1024, 2, 132, 232448),  # two layers of 1024 do not fit one launch together
    (1024, 2, 132, 100 * 1024),  # a card with less shared memory per block
    (512, 2, 16, 232448),  # too few SMs for the units a CTA can hold
])
def test_no_plan_where_nothing_fits(h, layers, sms, smem):
    assert lr.lstm_plan(h, layers, sms, smem) is None


def test_more_layers_than_one_launch_holds_have_no_plan():
    assert lr.lstm_plan(64, lr.MAX_LAYERS) is not None
    assert lr.lstm_plan(64, lr.MAX_LAYERS + 1) is None


def test_cpu_tensors_keep_nn_lstm(monkeypatch):
    """On the CPU the module runs ``torch.nn.LSTM`` and asks for no plan
    (the card test covers the fallback where no plan fits)."""
    asked = []
    monkeypatch.setattr("waveverify_torch.modules.audiocraft.device_plan",
                        lambda dev, h, layers: asked.append((h, layers)))
    m = StreamableLSTM(16, num_layers=3)
    seq = torch.randn(5, 2, 16)
    with torch.no_grad():
        assert torch.equal(m._recur(seq), m.lstm(seq)[0])  # the CPU asks nothing
    assert asked == []


# -- the plain version -----------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("frames", [1, 37])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_plain_version_against_the_loop(seed, frames, layers):
    """The plain version reads 0 to 7.3e-8 over these cases; the control
    fails ``LSTM_TOL`` (1.6e-6 to 3.1e-5) but for one frame through three
    layers, where the last layer's product is small beside the skip and
    the control reads 4.6e-7 to 4.9e-7."""
    h = 16
    g = torch.Generator().manual_seed(seed)
    p = lstm_params(seed, h, layers, scale=1 / 8, g=g)
    x = torch.randn(3, h, frames, generator=g)
    want = ra.lstm(F32, p, "l", x, layers)
    seq = x.permute(2, 0, 1)
    plan = lr.lstm_plan(h, layers)
    got = lr.lstm_recurrence(seq, as_weights(p, layers), plan) + seq
    assert rel_gap(got.permute(1, 2, 0), want) < LSTM_TOL, plan
    control = rel_gap(ra.lstm(TF32, p, "l", x, layers), want)
    assert control > (LSTM_TOL if frames > 1 or layers < 3 else 0.8 * LSTM_TOL)


def test_plain_version_is_the_cpu_dispatch():
    p = lstm_params(3, 8, 2, scale=1 / 8)
    seq = torch.randn(6, 2, 8)
    plan = lr.lstm_plan(8, 2)
    assert torch.equal(lr.lstm_recurrence(seq, as_weights(p, 2)),
                       lr.lstm_recurrence_ref(seq, as_weights(p, 2), plan))


# -- on the card -----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h", [64, 512])
@pytest.mark.parametrize("frames", [1, 37, 1500])
@pytest.mark.parametrize("batch", [1, 3, 8, 64])
def test_kernel_against_the_loop(h, frames, batch):
    """The kernel at every (B, T) against the reference's loop on the card;
    B = 64 runs eight batch groups in a launch, and in four launches of 16
    rows with a plan that holds 16."""
    dev = _card()
    p = lstm_params(h + frames + batch, h, 2, device=dev)
    x = torch.randn(batch, h, frames, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(frames))
    want = ra.lstm(F32, p, "l", x, 2)
    seq = x.permute(2, 0, 1).contiguous()
    plan = lr.device_plan(dev, h, 2)
    plans = [plan] + ([dataclasses.replace(plan, max_batch=16)] if batch > 16 else [])
    for pl in plans:
        before = lr.lstm_recurrence.launches
        with torch.no_grad():
            got = lr.lstm_recurrence(seq, as_weights(p, 2), pl) + seq
        torch.cuda.synchronize()
        assert lr.lstm_recurrence.launches - before == -(-batch // pl.max_batch)
        assert rel_gap(got.permute(1, 2, 0), want) < LSTM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("h,layers", [(1024, 2), (64, 3)])
def test_kernel_layered_and_deeper(h, layers):
    """Two layers of 1024 have no plan (the module keeps cuDNN there,
    ``test_torch_audioseal.py``); three layers of 64 run in one launch."""
    dev = _card()
    plan = lr.device_plan(dev, h, layers)
    if h == 1024:
        assert plan is None
        return
    p = lstm_params(h, h, layers, device=dev)
    x = torch.randn(8, h, 37, device=dev)
    seq = x.permute(2, 0, 1).contiguous()
    with torch.no_grad():
        got = lr.lstm_recurrence(seq, as_weights(p, layers), plan) + seq
    assert rel_gap(got.permute(1, 2, 0), ra.lstm(F32, p, "l", x, layers)) < LSTM_TOL


@pytest.mark.cuda
def test_kernel_smem_count_is_the_plans():
    _card()
    for h, layers in [(8, 2), (64, 3), (512, 2), (1024, 1)]:
        plan = lr.lstm_plan(h, layers)
        for batch in (1, 8, plan.max_batch):
            assert lr.kernel_smem_bytes(h, plan.units, batch) == lr.smem_bytes(
                h, plan.units, batch)
