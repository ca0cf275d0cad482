"""The WavMark cell on the CPU at a small size: the driver runs it end to end
and is correct, the planted faults are caught, the control fails where the
program passes; ``counts_wavmark`` counts the subnets' products as
FlopCounterMode counts the reference's; the readers ``inn_ms``,
``inn_roofline`` and ``stft_ms`` on a synthetic trace; the entries in
``BENCHMARK.json``."""

from __future__ import annotations

import copy
import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, ROOT, bench_spec
from counts import PEAKS, count_flop
from counts_wavmark import inn_bound_s, subnet_cost, subnet_shapes
from pbcore import faults, harness
from pbcore.trace import DeviceTrace, Tracer
from reference import wavmark as rw
from reference.ops import Ops

CELL = "serve.wavmark.embed_detect.b8x30s"
WORKLOAD = {"driver": "serve_wavmark", "batch": 2, "clip_s": 0.25, "pool": 2}
PUBLISHED = json.loads((BENCH / "configs" / "wavmark_32bits.json").read_text())
NAMES = ("inn_ms.wavmark", "inn_roofline.wavmark", "stft_ms.wavmark", "mfu.wavmark",
         "idle_share.wavmark")


def small_config() -> dict:
    """The configuration at 0.1 s segments, n_fft 64, hop 16, 2 blocks;
    growth, clamp, slope, bits and pattern as published."""
    c = copy.deepcopy(PUBLISHED)
    c["model"].update(num_point=1600, n_fft=64, hop_length=16, num_layers=2)
    return c


def _run(config, seconds=0.3):
    return harness.run_cell(bench_spec(), CELL, 4294967311, seconds, False,
                            torch.device("cpu"), time.perf_counter(), config=config,
                            workload=WORKLOAD)


def _conf_off(mp):
    """The timed call's confidence one pattern bit a clip too high."""
    from waveverify_torch.models.wavmark import WavMarkModels

    decide = WavMarkModels.decide
    mp.setattr(WavMarkModels, "decide", lambda self, v, t: (lambda p, c: (
        p, c + 1 / (16 * max(v.shape[1], 1))))(*decide(self, v, t)))


def _probs_off(mp):
    """The timed call's payload probabilities off by 1e-4, its bits and
    decoded values as they are."""
    from waveverify_torch.models.wavmark import WavMarkModels

    decide = WavMarkModels.decide
    mp.setattr(WavMarkModels, "decide", lambda self, v, t: (lambda p, c: (
        p + 1e-4, c))(*decide(self, v, t)))


def _threshold_at_zero(mp):
    """Payload bits read at 0 instead of 0.5."""
    from waveverify_torch.models.wavmark import WavMarkModels

    decide = WavMarkModels.decide
    mp.setattr(WavMarkModels, "decide", lambda self, v, t: (lambda p, c: (
        torch.clamp(p + 0.5, 0, 1), c))(*decide(self, v, t)))


@pytest.mark.parametrize("fault, check", [
    (None, None), ("half_batch", "wm_gap"), ("half_mean", "msg_gap"),
    (_conf_off, "bit_flips"), (_probs_off, "msg_gap"), (_threshold_at_zero, "bit_flips")])
def test_cell_runs_and_catches_faults(fault, check, monkeypatch):
    if isinstance(fault, str):
        faults.SERVE[fault](monkeypatch)
    elif fault is not None:
        fault(monkeypatch)
    r = _run(small_config())
    assert set(r["checks"]) == {"wm_gap", "msg_gap", "bit_flips"}
    assert r["attempted"] > 0
    assert {"setup_s", "audio_s_per_s", "call_ms_p95"} <= set(r["metrics"])
    assert r["correct"] is (fault is None), r["checks"]
    if check:
        assert r["checks"][check]["value"] > r["checks"][check]["limit"], r["checks"]


def test_control_fails_where_the_program_passes():
    ctx = harness.Context(CELL, 17, torch.device("cpu"), small_config(), WORKLOAD,
                          Tracer(False, harness.OUT_DIR))
    d = harness.load_module(harness.BENCH_DIR / "drivers" / "serve_wavmark.py").Driver(ctx)
    d.setup()
    d.run_window(0.2)
    d.release()
    program, control = d.check(), d.control_check()
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
    # the program's decoded values are well inside the control's gap
    gaps = {c["name"]: c["value"] for c in program["checks"]}
    ctrl = {c["name"]: c["value"] for c in control["checks"]}
    assert ctrl["msg_gap"] > 10 * gaps["msg_gap"]


def test_the_published_configuration():
    """The released model, nothing cut: 2,481,712 parameters."""
    entry = harness.config_entry(bench_spec(), "wavmark_32bits")
    assert entry["reduced"] == [] and PUBLISHED["reduced"] == []
    assert (ROOT / entry["file"]).exists()
    driver = harness.load_module(BENCH / "drivers" / "serve_wavmark.py")
    cfg = driver.reference_config(PUBLISHED["model"])
    assert cfg == rw.PUBLISHED
    assert sum(math.prod(s) for _, s, *_ in rw.state_spec(cfg)) == 2481712
    assert len(PUBLISHED["model"]["pattern"]) == 16


def test_subnet_counts_match_flop_counter():
    """One dense subnet of the reference: FlopCounterMode's count of its
    five convs is the formula's; a whole embed+decode adds the linears."""
    cfg = dict(rw.PUBLISHED, segment=1600, n_fft=64, hop=16, num_layers=2)
    p = rw.make_state_dict(0, cfg)
    x = torch.randn(3, 2, 7, 11, generator=torch.Generator().manual_seed(0))
    _, flop = count_flop(lambda: rw.subnet(Ops(), p, "hinet.inv_blocks.0.r", cfg, x))
    assert flop == subnet_cost(3, 7, 11)[0]
    audio = torch.randn(2, 4000, generator=torch.Generator().manual_seed(1))
    bits = torch.randint(0, 2, (2, 32), generator=torch.Generator().manual_seed(2)).float()
    _, flop = count_flop(lambda: (rw.embed(Ops(), p, cfg, audio, bits),
                                  rw.decode(Ops(), p, cfg, audio)))
    model = dict(PUBLISHED["model"], num_point=1600, n_fft=64, hop_length=16, num_layers=2)
    shapes = subnet_shapes(model, 2, 4000)
    assert shapes == [(4, 101, 33)] * 12
    linears = 2 * 2 * 32 * 1600 + 2 * 4 * 1600 * 32
    assert flop == sum(subnet_cost(*s)[0] for s in shapes) + linears


def test_a_call_s_subnets_at_the_published_size():
    """48 subnets a call at 8 x 30 s: 240 segments of 41 x 501, 1.231 G
    multiply-adds a segment each, 28.4 TFLOP, bound by FLOP at 57 ms."""
    model = PUBLISHED["model"]
    shapes = subnet_shapes(model, 8, 480000)
    assert shapes == [(240, 41, 501)] * 48
    f, n = subnet_cost(240, 41, 501)
    assert f / 240 / 2 == pytest.approx(1.231e9, rel=1e-3)
    assert 48 * f == pytest.approx(28.4e12, rel=2e-3)
    assert n == 4 * (2 * 240 * 2 * 41 * 501 + 60070)
    assert f / PEAKS["tf32_flop_per_s"] > n / PEAKS["hbm_bytes_per_s"]
    assert inn_bound_s(model, 8, 480000) == pytest.approx(28.4e12 / 495e12, rel=2e-3)


def _record(tmp_path, launches=("cuda_runtime", "cuda_driver"), n_iter=2):
    """An annotated stretch of ``n_iter`` calls written as a Chrome trace:
    per call two ``wavmark.inn`` ranges, each launching 24 kernels of 1 ms
    (alternately through the runtime and the driver, as ``launches`` says)
    under ``inn.block`` ranges, five spectra ranges launching a 100 us
    kernel each, and one kernel outside any range."""
    events = [{"cat": "user_annotation", "name": "pb:profiled", "ts": 0.0, "dur": 1e8}]
    corr = 0

    def launch(ts, dur, kind):
        nonlocal corr
        corr += 1
        events.append({"cat": kind, "name": "launch", "ts": ts, "dur": 1.0, "tid": 1,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": "k", "ts": ts + 50, "dur": dur,
                       "args": {"correlation": corr}})

    for call in range(n_iter):
        base = 1e6 + call * 1e7
        for j, name in enumerate(("wavmark.stft", "wavmark.stft", "wavmark.istft",
                                  "wavmark.stft", "wavmark.istft")):
            lo = base + j * 1e6
            events.append({"cat": "user_annotation", "name": name, "ts": lo, "dur": 20.0,
                           "tid": 1})
            launch(lo + 5, 100.0, launches[0])
        for p in range(2):
            lo = base + 5e5 + p * 3e6
            events.append({"cat": "user_annotation", "name": "wavmark.inn", "ts": lo,
                           "dur": 500.0, "tid": 1})
            for k in range(24):
                if k % 3 == 0:
                    events.append({"cat": "user_annotation", "name": "inn.block",
                                   "ts": lo + 10 + 20 * k, "dur": 59.0, "tid": 1})
                launch(lo + 11 + 20 * k, 1000.0, launches[k % len(launches)])
        launch(base + 9e6, 5000.0, "cuda_runtime")
    out = tmp_path / "build"
    out.mkdir(exist_ok=True)
    (out / "t.annotated.trace.json").write_text(json.dumps({"traceEvents": events}))
    published = copy.deepcopy(PUBLISHED)
    wl = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    return {"annotated": DeviceTrace(events, n_iter), "config": published, "workload": wl,
            "tracer": SimpleNamespace(out_dir=out, tag="t")}


def _read(name, record):
    return harness.load_module(harness.reader_path(BENCH / "layer_metrics", name)).read(record)


@pytest.mark.parametrize("launches", [("cuda_runtime",), ("cuda_runtime", "cuda_driver")])
def test_inn_and_stft_readers(launches, tmp_path):
    """48 subnet kernels of 1 ms a call: 48 ms, whichever API launched them,
    and the roofline share is the 48 subnets' bound over it; five spectra
    of 100 us: 0.5 ms."""
    record = _record(tmp_path, launches)
    assert _read("inn_ms.wavmark", record) == pytest.approx(48.0)
    bound = inn_bound_s(PUBLISHED["model"], 8, 480000)
    assert _read("inn_roofline.wavmark", record) == pytest.approx(bound / 48e-3 * 100.0)
    assert _read("stft_ms.wavmark", record) == pytest.approx(0.5)


def test_readers_find_nothing_on_a_port_without_the_ranges(tmp_path):
    record = _record(tmp_path)
    path = record["tracer"].out_dir / "t.annotated.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    for e in events:
        if e["name"].startswith("wavmark."):
            e["name"] = "other"
    path.write_text(json.dumps({"traceEvents": events}))
    for name in NAMES[:3]:
        assert _read(name, record) is None
        assert _read(name, {**record, "annotated": None}) is None
    path.unlink()
    assert _read("inn_ms.wavmark", record) is None


def test_wavmark_entries_are_in_the_benchmark():
    bench = bench_spec()
    metrics = {m["name"]: m for m in bench["per_layer"]}
    assert [m["name"] for m in bench["per_layer"][-5:]] == list(NAMES)
    for name in NAMES:
        m = metrics[name]
        assert (m["moves"], m["workloads"]) == ("audio_s_per_s", [CELL])
    assert {metrics[n]["layer"] for n in NAMES[:3]} == {"networks"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name in ("audio_s_per_s", "call_ms_p95"):
        assert e2e[name]["workloads"][-1] == CELL
    cell = harness.cell_entry(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("wavmark_32bits", CELL, 1)
