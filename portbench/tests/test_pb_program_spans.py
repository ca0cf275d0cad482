"""The readers of the port's own spans (``source: program_span``), on
synthetic span records and a small Chrome trace of the device stretch:
which roots the stretch keeps, the division by the roots kept, the host's
waits counted from the trace's blocking runtime calls, the idle time split
by span, and None where no root lies in the stretch or the port has no
spans."""

from __future__ import annotations

import json
import sys

import pytest

from conftest import BENCH, ROOT
from pbcore import harness, program_spans
from pbcore.trace import DeviceTrace, Tracer

BASE = 1_760_000_000_000_000_000  # the trace's baseTimeNanoseconds
TAG = "synthetic"
TRAIN = {"fwd_ms.train": "step.forward", "disc_ms.train": "step.disc",
         "gen_bwd_ms.train": "step.gen_backward", "update_ms.train": "step.update"}
SERVE = ("upload_ms.serve", "submit_ms.serve", "syncs_per_call.serve")
NEW = (*TRAIN, "syncs_per_step.train", *SERVE)
BLOCKING = ("cudaStreamSynchronize", "cudaMemcpy", "cudaDeviceSynchronize",
            "cudaEventSynchronize")


class _Spans:
    """Span records as ``waveverify_torch.spans`` makes them, and the CUDA
    runtime's calls of the trace, times in us on the trace's clock."""

    def __init__(self):
        self.records = []
        self.runtime = []

    def add(self, name, lo_us, hi_us, parent=None, waits=0, device_ms=None):
        """A span; ``waits`` blocking runtime calls inside it, each beside
        a launch and an ``Async`` copy, which do not block."""
        sid = len(self.records)
        root = sid if parent is None else self.records[parent]["root"]
        self.records.append({"name": name, "id": sid, "parent": parent, "root": root,
                             "start_ns": BASE + int(lo_us * 1e3),
                             "end_ns": BASE + int(hi_us * 1e3), "device_ms": device_ms})
        for w in range(waits):
            t = lo_us + 1 + 3 * w
            for call in (BLOCKING[(sid + w) % len(BLOCKING)], "cudaLaunchKernel",
                         "cudaMemcpyAsync"):
                self.runtime.append({"cat": "cuda_runtime", "name": call, "ts": t, "dur": 1.0})
        return sid

    def step(self, lo, scale=1.0, timed=True):
        """A train_step root of 2 ms at ``lo`` us with its four phases,
        their device ms 1, 2, 3, 4 times ``scale``; 3 + 1 waits."""
        root = self.add("train_step", lo, lo + 2000, waits=1)
        for j, name in enumerate(TRAIN.values()):
            self.add(name, lo + 100 + 400 * j, lo + 450 + 400 * j, root, waits=j % 2,
                     device_ms=(j + 1) * scale if timed else None)
        return root

    def call(self, lo):
        """An embed+detect call at ``lo`` us: each root with an upload
        (0.2 ms), the network (1 ms), a readback; 3 waits each."""
        for root_name, net in (("api.embed_batch", "api.generator"),
                               ("api.detect_batch", "api.detector")):
            root = self.add(root_name, lo, lo + 2000)
            self.add("api.upload", lo + 10, lo + 210, root, waits=2)
            self.add(net, lo + 300, lo + 1300, root)
            self.add("api.readback", lo + 1400, lo + 1900, root, waits=1)
            lo += 2000


def _record(tmp_path, spans, monkeypatch, lo=1000.0, window_s=0.01, kernels=(1000.0,)):
    """A traced run's record whose device stretch starts at ``lo`` us and
    lasts ``window_s``, with kernels of 5 us at ``lo`` and ``lo`` plus each
    of ``kernels``; the port's spans and runtime calls are ``spans``."""
    from waveverify_torch import spans as port_spans

    events = [{"cat": "kernel", "name": "k", "ts": lo + t, "dur": 5.0}
              for t in (0.0, *kernels)] + spans.runtime
    (tmp_path / f"{TAG}.device.trace.json").write_text(json.dumps(
        {"baseTimeNanoseconds": BASE, "traceEvents": events}))
    monkeypatch.setattr(port_spans, "drain", lambda: (list(spans.records), 0))
    return {"tracer": Tracer(True, tmp_path, tag=TAG),
            "trace": DeviceTrace(events, n_iter=2, window_s=window_s)}


def _read(name, record):
    return harness.load_module(harness.reader_path(BENCH / "layer_metrics", name)).read(record)


def test_train_readers_keep_the_roots_mostly_inside_the_stretch(tmp_path, monkeypatch):
    s = _Spans()
    s.step(500)             # 1500 of its 2000 us inside: kept
    s.step(3000, scale=3)   # inside: kept
    s.step(10500)           # 500 us inside: not kept
    s.step(20000, scale=9)  # the annotated stretch's: not kept
    rec = _record(tmp_path, s, monkeypatch)
    for j, name in enumerate(TRAIN):
        assert _read(name, rec) == pytest.approx((j + 1) * (1 + 3) / 2)  # per step
    assert _read("syncs_per_step.train", rec) == 3
    assert all(_read(n, rec) is None for n in SERVE)  # no call in a training run
    # the spans are drained once and written beside the stretch's trace
    written = json.loads((tmp_path / f"{TAG}.program_spans.json").read_text())
    assert written["baseTimeNanoseconds"] == BASE and len(written["spans"]) == 20
    assert sum(written["idle_ms_by_span"].values()) == pytest.approx(
        (10000 - 10) / 1e3 / 2)  # the stretch's idle time, per iteration


def test_serve_readers_divide_by_the_calls_kept(tmp_path, monkeypatch):
    s = _Spans()
    for lo in (1000, 5000, 11500):  # the third call lies outside
        s.call(lo)
    rec = _record(tmp_path, s, monkeypatch)
    assert _read("upload_ms.serve", rec) == pytest.approx(0.4)  # 0.2 ms a root
    assert _read("submit_ms.serve", rec) == pytest.approx(2.0)
    assert _read("syncs_per_call.serve", rec) == 6
    assert all(_read(n, rec) is None for n in (*TRAIN, "syncs_per_step.train"))


def test_a_root_name_with_nothing_kept_gives_none(tmp_path, monkeypatch):
    s = _Spans()
    s.call(1000)
    # a detect root without an embed root: no whole call in the stretch
    s.records = [r for r in s.records if r["root"] != 0]
    rec = _record(tmp_path, s, monkeypatch)
    assert program_spans.kept_roots(rec, "api.detect_batch")
    assert _read("syncs_per_call.serve", rec) is None


@pytest.mark.parametrize("case", ["outside", "untimed", "no_runtime", "no_spans_module",
                                  "no_trace"])
def test_readers_give_none_where_there_is_nothing_to_read(case, tmp_path, monkeypatch):
    s = _Spans()
    s.step(30000 if case == "outside" else 2000, timed=case != "untimed")
    s.call(30000 if case == "outside" else 5000)
    if case == "no_runtime":  # a trace without the runtime's calls
        s.runtime = []
    rec = _record(tmp_path, s, monkeypatch)
    if case == "no_spans_module":  # the parent's port
        import waveverify_torch

        monkeypatch.delattr(waveverify_torch, "spans")
        monkeypatch.setitem(sys.modules, "waveverify_torch.spans", None)
    if case == "no_trace":
        rec["trace"] = None
    got = {n: _read(n, rec) for n in NEW}
    if case == "untimed":  # spans without CUDA events: host numbers only
        assert all(got[n] is None for n in TRAIN)
        assert got["syncs_per_step.train"] == 3 and got["syncs_per_call.serve"] == 6
    elif case == "no_runtime":  # the waits alone cannot be read
        assert got["syncs_per_step.train"] is None and got["syncs_per_call.serve"] is None
        assert all(got[n] is not None for n in NEW if not n.startswith("syncs")), got
    else:
        assert all(v is None for v in got.values()), got


@pytest.mark.parametrize("name,blocks", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaMemcpy", True), ("cudaMemcpy2D_v3020", True),
    ("cudaMemcpyAsync", False), ("cudaMemcpy2DAsync_v3020", False),
    ("cudaLaunchKernel", False), ("cudaStreamWaitEvent", False), ("cudaEventRecord", False),
])
def test_blocking_runtime_calls(name, blocks):
    assert program_spans.blocking(name) is blocks


def test_idle_by_span_labels_each_gap_by_the_innermost_open_span(tmp_path, monkeypatch):
    s = _Spans()
    s.step(500)   # root [500, 2500]; step.disc [1000, 1350], step.update [1800, 2150]
    s.step(3000)  # root [3000, 5000]
    # kernels at 1000 (the stretch's start), 2000, 2600 and 9000, 5 us each
    rec = _record(tmp_path, s, monkeypatch, kernels=(1000.0, 1600.0, 8000.0))
    _read("fwd_ms.train", rec)  # loads the spans once
    records, base = rec[program_spans.KEY]
    got = program_spans.idle_by_span(rec["trace"], records, base)
    # gaps (1005, 2000) in step.disc, (2005, 2600) in step.update, (2605, 9000)
    # outside either root, (9005, 11000) after both; two iterations
    want = {"step.disc": 995 / 2e3, "step.update": 595 / 2e3,
            "outside": (6395 + 1995) / 2e3}
    assert got == pytest.approx(want)
    tr = rec["trace"]
    assert sum(got.values()) == pytest.approx((tr.window_s - tr.busy_s) * 1e3 / 2)
    written = json.loads((tmp_path / f"{TAG}.program_spans.json").read_text())
    assert written["idle_ms_by_span"] == pytest.approx(want)
    assert (written["lo_us"], written["hi_us"], written["n_iter"]) == (1000.0, 11000.0, 2)


def test_a_span_is_open_at_both_its_ends():
    s = _Spans()
    root = s.add("root", 0, 100)
    s.add("inner", 10, 20, root)
    times = [0.0, 5.0, 10.0, 20.0, 20.5, 100.0, 100.5]
    assert program_spans._innermost(s.records, BASE, times) == [
        "root", "root", "inner", "inner", "root", "root", None]


def test_every_new_metric_is_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        assert harness.reader_path(BENCH / "layer_metrics", name).exists()
        cell = "train.step.b32" if name.endswith(".train") else "serve.embed_detect.b64"
        assert m["workloads"] == [cell]
