"""The AudioSeal cell on the CPU at a small size: the driver runs it end to
end and is correct, the planted faults are caught, the control fails where
the program passes, and ``counts_audioseal`` counts the recurrences'
products as FlopCounterMode counts the reference's."""

from __future__ import annotations

import copy
import json
import math
import time

import pytest
import torch

from conftest import BENCH, ROOT, bench_spec
from counts import count_flop
from counts_audioseal import lstm_bound_s, lstm_cost, lstm_shapes
from pbcore import faults, harness
from pbcore.trace import Tracer
from reference import audioseal as ra
from reference.ops import Ops

CELL = "serve.audioseal.embed_detect.b8x30s"
WORKLOAD = {"driver": "serve_audioseal", "batch": 2, "clip_s": 0.0625, "pool": 2}
PUBLISHED = json.loads((BENCH / "configs" / "audioseal_16bits.json").read_text())


def small_config() -> dict:
    """The configuration at small widths (n_filters 4, dimension 8, ratios
    2, 2), both cards alike; every other option as published."""
    c = copy.deepcopy(PUBLISHED)
    for card in c["model"].values():
        card["seanet"].update(n_filters=4, dimension=8, ratios=[2, 2])
    c["model"]["detector"]["detector"]["output_dim"] = 8
    return c


def _run(config, seconds=0.3):
    return harness.run_cell(bench_spec(), CELL, 4294967311, seconds, False,
                            torch.device("cpu"), time.perf_counter(), config=config,
                            workload=WORKLOAD)


@pytest.mark.parametrize("fault", [None, "half_batch", "half_mean"])
def test_cell_runs_and_catches_faults(fault, monkeypatch):
    if fault:
        faults.SERVE[fault](monkeypatch)
    r = _run(small_config())
    assert r["correct"] is (fault is None), r["checks"]
    assert r["attempted"] > 0
    assert set(r["checks"]) == {"wm_gap", "msg_gap", "score_flips", "bit_flips",
                                "presence_gap"}
    assert {"setup_s", "audio_s_per_s", "call_ms_p95"} <= set(r["metrics"])


def _score_off(mp):
    """The timed call's detection score ten samples a clip too high."""
    from waveverify_torch.models.audioseal import AudioSealModels, decide

    mp.setattr(AudioSealModels, "decide", staticmethod(
        lambda logits, t: (lambda p, s: (p, s + 10 / max(t, 1)))(*decide(logits, t))))


def _probs_off(mp):
    """The timed call's message probabilities off by 1e-4, its bits and
    every other path as they are."""
    from waveverify_torch.models.audioseal import AudioSealModels, decide

    mp.setattr(AudioSealModels, "decide", staticmethod(
        lambda logits, t: (lambda p, s: (p + 1e-4, s))(*decide(logits, t))))


@pytest.mark.parametrize("fault, check", [(_score_off, "score_flips"),
                                          (_probs_off, "msg_gap")])
def test_faults_of_the_timed_detection_alone_are_caught(fault, check, monkeypatch):
    """A fault that lives only in ``detect_batch``'s decision (not in the
    generator, the detector or ``locate_array``'s path) reads incorrect."""
    fault(monkeypatch)
    r = _run(small_config())
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"], r["checks"]
    assert r["checks"]["presence_gap"]["value"] <= r["checks"]["presence_gap"]["limit"]


def test_control_fails_where_the_program_passes():
    ctx = harness.Context(CELL, 17, torch.device("cpu"), small_config(), WORKLOAD,
                          Tracer(False, harness.OUT_DIR))
    d = harness.load_module(harness.BENCH_DIR / "drivers" / "serve_audioseal.py").Driver(ctx)
    d.setup()
    d.run_window(0.2)
    d.release()
    program, control = d.check(), d.control_check()
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]


def test_the_published_configuration():
    """Both cards' widths, nothing cut; the generator and the detector hold
    14.68 M and 8.65 M parameters."""
    entry = harness.config_entry(bench_spec(), "audioseal_16bits")
    assert entry["reduced"] == [] and PUBLISHED["reduced"] == []
    assert (ROOT / entry["file"]).exists()
    cfg = harness.load_module(BENCH / "drivers" / "serve_audioseal.py").reference_config(
        PUBLISHED["model"])
    assert cfg["n_filters"] == 32 and cfg["ratios"] == [8, 5, 4, 2] and cfg["lstm"] == 2
    n_g = sum(math.prod(s) for _, s, *_ in ra.generator_spec(cfg))
    n_d = sum(math.prod(s) for _, s, *_ in ra.detector_spec(cfg))
    assert (n_g, n_d) == (14679906, 8649138)


def test_lstm_counts_match_flop_counter():
    """The LSTM's products in the reference, by FlopCounterMode, against
    the formula; both layers of one LSTM."""
    cfg = small_config()["model"]["generator"]["seanet"]
    b, frames, dim = 3, 7, 32
    p = {}
    g = torch.Generator().manual_seed(0)
    for key, shape, *_ in ra._lstm_spec("x", dim, 2):
        p[key] = torch.rand(shape, generator=g)
    x = torch.randn(b, dim, frames, generator=g)
    _, flop = count_flop(lambda: ra.lstm(Ops(), p, "x", x, 2))
    assert flop == 2 * lstm_cost(b, frames, dim, dim)[0]
    # a call's three LSTMs at the published widths: 302 GFLOP for 8 x 30 s
    pub = PUBLISHED["model"]["generator"]["seanet"]
    assert lstm_shapes(pub, 480000) == [[(1500, 512, 512)] * 2] * 3
    flop = sum(lstm_cost(8, *layer)[0] for net in lstm_shapes(pub, 480000) for layer in net)
    assert flop == pytest.approx(302e9, rel=2e-3)
    assert lstm_bound_s(pub, 8, 480000) == pytest.approx(302e9 / 495e12, rel=2e-3)
    assert lstm_shapes(cfg, 1000) == [[(250, 16, 16)] * 2] * 3
